"""The flash-attention gradient of the port (CPU): the plain backward
(``ref.flash_attention_bwd_ref``, what the backward kernels compute)
against float64 autograd of ``ref.flash_attention_ref`` and a
``gradcheck``; ``FlashAttentionFn`` through ``layers.chunked_attention``
against ``jax.grad`` of the reference's ``chunked_attention``; the
function under ``torch.utils.checkpoint``; the training and serving
routes of ``chunked_attention`` and of the layer params.  The kernels
themselves run on the card only (``chip_smoke.py``,
``tests/test_torch_card.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.transformer import (layer_params,  # noqa: E402
                                            unbind_layers)

JAX_TOL = 1e-5           # f32 both sides; only summation orders differ

# (B, H, Hkv, Sq, Sk, D, causal): GQA groups 1-4, full attention with
# Sq != Sk, a causal length that is no tile multiple
SHAPES = [(2, 4, 2, 7, 7, 8, True), (1, 6, 3, 5, 9, 16, False),
          (1, 2, 1, 33, 33, 8, True), (2, 4, 4, 12, 12, 16, False),
          (1, 8, 2, 40, 40, 32, True)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several test processes
    on the host's cores, and torch's per-process thread pools
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, dtype, seed=0):
    b, h, hkv, sq, sk, d, _ = shape
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s)).to(dtype)
    return mk(b, h, sq, d), mk(b, hkv, sk, d), mk(b, hkv, sk, d), \
        mk(b, h, sq, d)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_is_float64_autograd(shape):
    causal = shape[-1]
    q, k, v, do = _inputs(shape, torch.float64)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ref.flash_attention_ref(*leaves, causal=causal)
    want = torch.autograd.grad(out, leaves, do)
    o2, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal)
    assert torch.equal(o2, out.detach())
    got = ref.flash_attention_bwd_ref(q, k, v, o2, lse, do, causal=causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-12


class _PlainFn(torch.autograd.Function):
    """The plain forward with lse and the plain backward as one autograd
    function, for ``gradcheck`` in float64."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = ref.flash_attention_lse_ref(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                             ctx.causal), None)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_gradcheck(causal):
    q, k, v, _ = _inputs((1, 4, 2, 5, 5, 8, causal), torch.float64, seed=1)
    args = [t.requires_grad_(True) for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: _PlainFn.apply(a, b, c, causal), args)


def test_lse_is_the_masked_logsumexp():
    q, k, v, _ = _inputs((1, 4, 2, 9, 9, 8, True), torch.float32)
    _, lse = ref.flash_attention_lse_ref(q, k, v, causal=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(2, 1))
    s = s / np.sqrt(8)
    s = s.masked_fill(~torch.ones(9, 9, dtype=torch.bool).tril(), -np.inf)
    assert float((lse - torch.logsumexp(s, -1)).abs().max()) <= 1e-6


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_chunked_attention_grad_matches_jax(shape):
    """``layers.chunked_attention`` under autograd (``FlashAttentionFn``
    on CPU tensors) against ``jax.vjp`` of the reference's
    ``chunked_attention`` on the same inputs and cotangent."""
    causal = shape[-1]
    q, k, v, do = (t.transpose(1, 2).contiguous()      # [B, S, H, D]
                   for t in _inputs(shape, torch.float32, seed=2))
    out, vjp = jax.vjp(
        lambda a, b, c: JL.chunked_attention(a, b, c, causal=causal),
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got_out = L.chunked_attention(*leaves, causal=causal)
    got = torch.autograd.grad(got_out, leaves, do)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               atol=JAX_TOL, rtol=JAX_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=JAX_TOL,
                                   rtol=JAX_TOL)


def test_flash_fn_under_checkpoint(monkeypatch):
    """Under ``torch.utils.checkpoint`` the forward runs twice (the
    recompute) and the gradients are those of a plain backward pass."""
    calls = []
    real = FA.flash_attention_lse
    monkeypatch.setattr(FA, "flash_attention_lse",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v, do = _inputs((2, 4, 2, 16, 16, 8, True), torch.float32, seed=3)

    def f(a, b, c):
        return torch.tanh(FA.flash_attention_with_grad(a, b, c, True))

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(f(*leaves), leaves, do)
    assert len(calls) == 1
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = torch.utils.checkpoint.checkpoint(f, *leaves, use_reentrant=False)
    got = torch.autograd.grad(out, leaves, do)
    assert len(calls) == 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_chunked_attention_routes(monkeypatch):
    """Serving (no gradient) calls the forward-only wrapper; training
    calls the autograd one."""
    seen = []
    for name in ("flash_attention", "flash_attention_with_grad"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _r=real, **kw:
                            seen.append(_n) or _r(*a, **kw))
    q, k, v, _ = (t.transpose(1, 2) for t in
                  _inputs((1, 2, 1, 6, 6, 8, True), torch.float32))
    with torch.no_grad():
        L.chunked_attention(q, k, v, causal=True)
    L.chunked_attention(q, k, v, causal=True)                 # no leaf
    L.chunked_attention(q.requires_grad_(True), k, v, causal=True)
    assert seen == ["flash_attention", "flash_attention",
                    "flash_attention_with_grad"]


def test_unbind_route_keeps_serving_views():
    """The training route takes the layers by one ``unbind`` a leaf; the
    serving route's ``layer_params`` stays a view of the stack, and the
    two see the same values."""
    cfg = get_arch("granite_3_2b").reduced()
    model = get_model(cfg, remat="full")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    stack = params["layers"]["attn"]["wq"]
    lp = layer_params(params["layers"], 1)
    assert lp["attn"]["wq"].data_ptr() == stack[1].data_ptr()
    assert lp["attn"]["wq"]._base is stack
    ub = unbind_layers(params["layers"], cfg.n_layers)
    assert len(ub) == cfg.n_layers
    for li in range(cfg.n_layers):
        for a, b in zip(L_leaves(ub[li]), L_leaves(layer_params(
                params["layers"], li))):
            assert a.data_ptr() == b.data_ptr() and torch.equal(a, b)

    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        before, _ = model.prefill(params, {"tokens": tokens})
    live = {k: v for k, v in params.items()}
    live["layers"] = _requires_grad(params["layers"])
    loss, _ = model.loss(live, {"tokens": tokens, "labels": tokens})
    loss.backward()
    assert live["layers"]["attn"]["wq"].grad.shape == stack.shape
    with torch.no_grad():
        after, _ = model.prefill(params, {"tokens": tokens})
    assert torch.equal(before, after)


def L_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in L_leaves(v)]
    return [tree]


def _requires_grad(tree):
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def test_backward_wrapper_checks():
    q, k, v, do = _inputs((1, 4, 2, 6, 6, 8, True), torch.float32)
    out, lse = FA.flash_attention_lse(q, k, v, causal=True)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_attention_bwd(q, k, v, out, lse[..., :-1], do, True)
    with pytest.raises(ValueError, match="dout"):
        FA.flash_attention_bwd(q, k, v, out, lse, do[..., :4], True)
    with pytest.raises(TypeError, match="float32"):
        FA.flash_attention_bwd(q, k, v, out, lse, do.double(), True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        FA.flash_attention_bwd(q, k[:, :, :5], v[:, :, :5], out, lse, do,
                               True)
    dq, dk, dv = FA.flash_attention_bwd(q, k, v, out, lse, do, True)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
