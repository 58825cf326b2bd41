"""The port's training kernels on the card (flash attention and the wkv
scan, forward with its saved values and backward): run there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

Imports torch only (the machine with the card has no JAX); every test
is marked ``cuda`` and skips without a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs these "
                    "kernels on one)")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


def _inputs(shape, seed):
    b, h, hkv, sq, sk, d = shape
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s, dtype=np.float32)).cuda()
    return mk(b, h, sq, d), mk(b, hkv, sk, d), mk(b, hkv, sk, d), \
        mk(b, h, sq, d)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((2, 8, 2, 77, 77, 64), True),
                                          ((1, 16, 2, 100, 100, 128), True),
                                          ((1, 4, 4, 40, 56, 160), False)],
                         ids=["mma-causal", "mma-d128-group8", "fma-full"])
def test_flash_training_kernels_on_the_card(card, shape, causal):
    """The forward with lse bit-equal in ``out`` to the forward-only
    kernel and its lse within 1e-5; the backward (the 3xTF32 route at
    D=64 and at D=128 with a group of 8, the FMA route at D=160) within
    1e-4 x max(1, max |plain|) of the plain version and deterministic;
    one launch a call."""
    q, k, v, do = _inputs(shape, seed=4)
    before = dict(FA.LAUNCHES)
    out, lse = FA.flash_attention_lse(q, k, v, causal=causal)
    assert torch.equal(out, FA.flash_attention(q, k, v, causal=causal))
    _, plain_lse = ref.flash_attention_lse_ref(q, k, v, causal)
    assert float((lse - plain_lse).abs().max()) <= 1e-5
    got = FA.flash_attention_bwd(q, k, v, out, lse, do, causal)
    again = FA.flash_attention_bwd(q, k, v, out, lse, do, causal)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        lim = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= lim
    assert FA.LAUNCHES["flash_attention_fwd_lse_f32"] == \
        before["flash_attention_fwd_lse_f32"] + 1
    assert FA.LAUNCHES["flash_attention_bwd_f32"] == \
        before["flash_attention_bwd_f32"] + 2


@pytest.mark.cuda
def test_flash_fn_trains_through_the_kernels(card):
    """``FlashAttentionFn`` on card tensors launches the kernels (no plain
    fallback) and its gradients match the plain forward's autograd."""
    q, k, v, do = _inputs((2, 4, 2, 64, 64, 32), seed=5)
    before = dict(FA.LAUNCHES)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(FA.flash_attention_with_grad(*leaves, True),
                              leaves, do)
    assert FA.LAUNCHES["flash_attention_bwd_f32"] == \
        before["flash_attention_bwd_f32"] + 1
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*leaves, True),
                               leaves, do)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * max(
            1.0, float(w.abs().max()))


def _wkv_inputs(b, s, h, dk, dv, seed, sigma=1.0):
    """(r, k, v, logw, u, s0, do, dsT) on the card, f32, logw =
    -exp(N(0, sigma))."""
    rng = np.random.default_rng(seed)
    mk = lambda x: torch.from_numpy(x.astype(np.float32)).cuda()
    r, k = (mk(rng.standard_normal((b, s, h, dk))) for _ in range(2))
    v = mk(rng.standard_normal((b, s, h, dv)))
    logw = mk(-np.exp(sigma * rng.standard_normal((b, s, h, dk))))
    u = mk(rng.standard_normal((h, dk)))
    s0 = mk(rng.standard_normal((b, h, dk, dv)))
    do = mk(rng.standard_normal((b, s, h, dv)))
    dsT = mk(rng.standard_normal((b, h, dk, dv)))
    return r, k, v, logw, u, s0, do, dsT


def _close(got, want, tol=1e-4):
    """max |got - want| within tol x max(1, max |want|)."""
    return float((got - want).abs().max()) <= tol * max(
        1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_wkv_states_kernel_on_the_card(card):
    """``rwkv_scan_states_f32``: o and sT bit-equal to ``rwkv_scan_f32``,
    the step states within 1e-4 x max(1, max |plain|) of
    ``ref.wkv_states_ref``; one launch a call."""
    from repro_torch.kernels import rwkv_scan as W
    r, k, v, logw, u, s0, _, _ = _wkv_inputs(2, 128, 4, 64, 64, seed=6)
    before = dict(W.LAUNCHES)
    o, s_t, states = W.rwkv_scan_states(r, k, v, logw, u, s0, chunk=32)
    want_o, want_s = W.rwkv_scan(r, k, v, logw, u, s0, chunk=32)
    assert torch.equal(o, want_o) and torch.equal(s_t, want_s)
    assert _close(states, ref.wkv_states_ref(k, v, logw, s0,
                                             ref.wkv_step_tokens(32)))
    assert W.LAUNCHES["rwkv_scan_states_f32"] == \
        before["rwkv_scan_states_f32"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 4, 64, 64, 32),
                                   (2, 96, 3, 32, 96, 32)],
                         ids=["mma-64x64", "fma-dk32-dv96"])
def test_wkv_bwd_kernel_on_the_card(card, shape):
    """``rwkv_scan_bwd_f32`` (its state pass, chunk pass and du sum) at
    64 x 64 (the tensor-core products) and at dk != dv: every gradient
    within 1e-4 x max(1, max |plain|) of ``ref.wkv_chunked_bwd_ref``, two
    runs bit-equal, one launch a call."""
    from repro_torch.kernels import rwkv_scan as W
    b, s, h, dk, dv, chunk = shape
    r, k, v, logw, u, s0, do, dsT = _wkv_inputs(b, s, h, dk, dv, seed=7)
    _, s_t, states = W.rwkv_scan_states(r, k, v, logw, u, s0, chunk=chunk)
    before = dict(W.LAUNCHES)
    got = W.rwkv_scan_bwd(r, k, v, logw, u, s0, states, s_t, do, dsT,
                          chunk=chunk)
    again = W.rwkv_scan_bwd(r, k, v, logw, u, s0, states, s_t, do, dsT,
                            chunk=chunk)
    assert W.LAUNCHES["rwkv_scan_bwd_f32"] == \
        before["rwkv_scan_bwd_f32"] + 2
    want = ref.wkv_chunked_bwd_ref(r, k, v, logw, u, s0, do, dsT,
                                   chunk=chunk)
    for name, g, a, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                             again, want):
        assert g.shape == w.shape, name
        assert torch.equal(g, a), name
        assert _close(g, w), name


@pytest.mark.cuda
def test_wkv_scan_fn_trains_through_the_kernels(card):
    """``WkvScanFn`` on card tensors launches the states variant and the
    backward (no plain fallback), and its gradients match the plain
    forward's autograd within 1e-4 x max(1, max |plain|)."""
    from repro_torch.kernels import rwkv_scan as W
    r, k, v, logw, u, s0, do, dsT = _wkv_inputs(2, 64, 2, 64, 64, seed=8)
    before = dict(W.LAUNCHES)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u, s0)]
    o, s_t = W.rwkv_scan_with_grad(*leaves, chunk=32)
    got = torch.autograd.grad((o, s_t), leaves, (do, dsT))
    assert W.LAUNCHES["rwkv_scan_states_f32"] == \
        before["rwkv_scan_states_f32"] + 1
    assert W.LAUNCHES["rwkv_scan_bwd_f32"] == before["rwkv_scan_bwd_f32"] + 1
    assert W.LAUNCHES["rwkv_scan_f32"] == before["rwkv_scan_f32"]
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u, s0)]
    o, s_t = ref.wkv_chunked_ref(*leaves, chunk=32)
    want = torch.autograd.grad((o, s_t), leaves, (do, dsT))
    for g, w in zip(got, want):
        assert _close(g, w)
