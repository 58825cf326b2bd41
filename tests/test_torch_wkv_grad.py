"""The wkv-scan gradient of the port (CPU): the plain backward
``ref.wkv_chunked_bwd_ref`` (what the backward kernel computes, by chunks
in reverse, dlogw by the gated-linear-attention identity) against float64
autograd through the per-token recurrence ``ref.wkv_ref`` and against
``jax.vjp`` of the reference's ``wkv_chunked``; ``WkvScanFn`` under
``gradcheck`` in float64 and under ``torch.utils.checkpoint``; the
states the forward kernel's states variant writes (``ref.wkv_states_ref``);
the backward kernel's plan (``ref.wkv_bwd_chunks_emulated``: the state
pass walking the gradient of the state back over the forward's steps,
then every step at once from its saved state, log2 decays summed in
double, du's step and batch shares summed in order) against the plain
backward and float64; the state pass's gradient states
(``ref.wkv_grad_states_ref``) against a float64 reverse recurrence; the
RWKV6 layer's training and serving routes.  The kernels themselves run
on the card only (``chip_smoke.py``, ``tests/test_torch_card.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.rwkv_scan import WkvScanFn  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402

F64_TOL = 1e-9     # float64 both sides: only the association differs
# f32 against float64 or the JAX package's f32: times max(1, max |exact|);
# the chunk forms' exponents are differences of f32 cumulative sums (the
# kernel's plan: of double sums rounded to f32)
GRAD_TOL = 1e-4

# (B, S, H, dk, dv, chunk, sigma): chunks 8-64, dk != dv both ways, one
# chunk, harsh decays (sigma 2: logw = -exp(N(0, 2)), w down to ~1e-22)
CASES = [(2, 32, 2, 8, 8, 8, 1.0), (1, 48, 2, 8, 12, 16, 1.0),
         (2, 64, 1, 12, 8, 32, 1.0), (1, 128, 2, 8, 8, 64, 1.0),
         (1, 16, 3, 4, 4, 16, 1.0), (2, 64, 2, 8, 8, 16, 2.0),
         (1, 64, 1, 16, 8, 32, 2.0)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several test processes
    on the host's cores, and torch's per-process thread pools
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, h, dk, dv, sigma, seed=0):
    """(r, k, v, logw, u, s0, do, dsT) as float64 numpy: nonzero s0 and
    dsT."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((b, s, h, dk)) for _ in range(2))
    v = rng.standard_normal((b, s, h, dv))
    logw = -np.exp(sigma * rng.standard_normal((b, s, h, dk)))
    u = rng.standard_normal((h, dk))
    s0 = rng.standard_normal((b, h, dk, dv))
    do = rng.standard_normal((b, s, h, dv))
    dsT = rng.standard_normal((b, h, dk, dv))
    return r, k, v, logw, u, s0, do, dsT


def _exact(args):
    """float64 autograd through the per-token recurrence."""
    ins = [torch.tensor(a, requires_grad=True) for a in args[:6]]
    o, s_t = ref.wkv_ref(*ins)
    ((o * torch.from_numpy(args[6])).sum() +
     (s_t * torch.from_numpy(args[7])).sum()).backward()
    return [x.grad for x in ins]


def _err(got, want):
    """max |got - want| over max(1, max |want|)."""
    want = torch.from_numpy(np.array(want, dtype=np.float64))
    return float((got.double() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


@pytest.mark.parametrize("b,s,h,dk,dv,chunk,sigma", CASES)
def test_bwd_ref_matches_float64_autograd(b, s, h, dk, dv, chunk, sigma):
    args = _inputs(b, s, h, dk, dv, sigma)
    exact = _exact(args)
    got64 = ref.wkv_chunked_bwd_ref(*map(torch.from_numpy, args),
                                    chunk=chunk)
    got32 = ref.wkv_chunked_bwd_ref(
        *(torch.from_numpy(a).float() for a in args), chunk=chunk)
    for name, g64, g32, want in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"),
                                    got64, got32, exact):
        assert g64.shape == want.shape, name
        assert _err(g64, want) <= F64_TOL, name
        assert g32.dtype == torch.float32
        assert _err(g32, want) <= GRAD_TOL, name


@pytest.mark.parametrize("b,s,h,dk,dv,chunk,sigma",
                         [c for c in CASES if c[-1] == 1.0])
def test_bwd_ref_matches_jax_vjp(b, s, h, dk, dv, chunk, sigma):
    """Against ``jax.vjp`` of the reference's ``wkv_chunked`` in f32 (its
    gradient is autodiff of that plain form; the harsh decays are held
    to float64 only, where both f32 chunk forms lose digits)."""
    args = [a.astype(np.float32) for a in _inputs(b, s, h, dk, dv, sigma)]
    _, vjp = jax.vjp(lambda *x: jrwkv.wkv_chunked(*x, chunk=chunk),
                     *map(jnp.asarray, args[:6]))
    want = vjp((jnp.asarray(args[6]), jnp.asarray(args[7])))
    got = ref.wkv_chunked_bwd_ref(*map(torch.from_numpy, args), chunk=chunk)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                          want):
        assert _err(g, w) <= GRAD_TOL, name


def test_wkv_scan_fn_gradcheck():
    """``WkvScanFn`` (the plain versions on the CPU) in float64: every
    input's gradient against finite differences, o and sT both used."""
    rng = np.random.default_rng(3)
    b, s, h, dk, dv = 1, 8, 2, 4, 4
    ins = [torch.tensor(x, requires_grad=True) for x in (
        rng.standard_normal((b, s, h, dk)), rng.standard_normal((b, s, h, dk)),
        rng.standard_normal((b, s, h, dv)),
        -np.exp(0.5 * rng.standard_normal((b, s, h, dk))),
        rng.standard_normal((h, dk)), rng.standard_normal((b, h, dk, dv)))]
    assert torch.autograd.gradcheck(
        lambda *x: WkvScanFn.apply(*x, 4), ins, eps=1e-6, atol=1e-6)


def test_wkv_scan_fn_is_rwkv_scan_with_its_gradient():
    """The autograd function's outputs are ``rwkv_scan``'s, bit for bit;
    its gradients are the plain backward's (on the CPU)."""
    args = [torch.from_numpy(a).float() for a in _inputs(2, 64, 2, 8, 8, 1.0)]
    ins = [a.clone().requires_grad_(True) for a in args[:6]]
    o, s_t = ops.rwkv_scan_with_grad(*ins, chunk=32)
    want_o, want_s = ops.rwkv_scan(*args[:6], chunk=32)
    assert torch.equal(o, want_o) and torch.equal(s_t, want_s)
    ((o * args[6]).sum() + (s_t * args[7]).sum()).backward()
    want = ref.wkv_chunked_bwd_ref(*args, chunk=32)
    for x, w in zip(ins, want):
        assert torch.equal(x.grad, w)


def test_wkv_scan_fn_under_checkpoint():
    """Recomputed in the backward pass (``torch.utils.checkpoint``), the
    function gives the same gradients, bit for bit."""
    from torch.utils.checkpoint import checkpoint
    args = [torch.from_numpy(a).float() for a in _inputs(1, 32, 2, 8, 4, 1.0)]
    grads = []
    for remat in (False, True):
        ins = [a.clone().requires_grad_(True) for a in args[:6]]
        fn = (lambda *x: checkpoint(ops.rwkv_scan_with_grad, *x, chunk=16,
                                    use_reentrant=False)) if remat else (
            lambda *x: ops.rwkv_scan_with_grad(*x, chunk=16))
        o, s_t = fn(*ins)
        ((o * args[6]).sum() + (s_t * args[7]).sum()).backward()
        grads.append([x.grad for x in ins])
    for a, w in zip(*grads):
        assert torch.equal(a, w)


@pytest.mark.parametrize("chunk", [8, 20, 32, 64])
def test_states_are_the_recurrence_at_every_step(chunk):
    """``rwkv_scan_states`` on the CPU: o and sT are ``rwkv_scan``'s bit for
    bit, and the states (at every ``wkv_step_tokens(chunk)`` tokens,
    entry 0 = s0) are the per-token recurrence's there."""
    b, s, h, dk, dv = 2, 120 if chunk == 20 else 128, 2, 8, 4
    args = [torch.from_numpy(a).float()
            for a in _inputs(b, s, h, dk, dv, 1.0)[:6]]
    o, s_t, states = ops.rwkv_scan_states(*args, chunk=chunk)
    want_o, want_s = ops.rwkv_scan(*args, chunk=chunk)
    assert torch.equal(o, want_o) and torch.equal(s_t, want_s)
    step = ref.wkv_step_tokens(chunk)
    assert states.shape == (b, h, s // step, dk, dv)
    assert torch.equal(states[:, :, 0], args[5])
    r, k, v, logw, u, s0 = (a.double() for a in args)
    for c in range(1, s // step):
        _, want = ref.wkv_ref(r[:, :c * step], k[:, :c * step],
                              v[:, :c * step], logw[:, :c * step], u, s0)
        assert _err(states[:, :, c], want) <= 1e-5


@pytest.mark.parametrize("b,s,h,dk,dv,chunk,sigma", CASES)
def test_bwd_plan_emulation_matches_plain_and_float64(b, s, h, dk, dv,
                                                      chunk, sigma):
    """The kernel's plan (state pass, then every step from the states
    variant's states) within GRAD_TOL of the plain backward and of
    float64 autograd, harsh decays included."""
    args = _inputs(b, s, h, dk, dv, sigma)
    exact = _exact(args)
    t = [torch.from_numpy(a).float() for a in args]
    _, _, states = ops.rwkv_scan_states(*t[:6], chunk=chunk)
    got = ref.wkv_bwd_chunks_emulated(*t[:5], states, t[6], t[7])
    plain = ref.wkv_chunked_bwd_ref(*t, chunk=chunk)
    for name, g, p, x in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                             plain, exact):
        assert g.shape == p.shape, name
        assert _err(g, p) <= GRAD_TOL, name
        assert _err(g, x) <= GRAD_TOL, name


@pytest.mark.parametrize("b,s,h,dk,dv,chunk,sigma", CASES)
def test_grad_states_match_float64_reverse_recurrence(b, s, h, dk, dv,
                                                      chunk, sigma):
    """The state pass (``ref.wkv_grad_states_ref``, f32): the gradient of
    the state after every step, and ds0, within GRAD_TOL x max(1, max
    |exact|) of the per-token reverse recurrence G_{t-1} = diag(w_t) G_t +
    r_t dO_t^T in float64 from G = dsT, harsh decays included."""
    r, _, _, logw, _, _, do, dsT = _inputs(b, s, h, dk, dv, sigma)
    step = ref.wkv_step_tokens(min(chunk, s))
    gs, ds0 = ref.wkv_grad_states_ref(
        *(torch.from_numpy(x).float() for x in (r, logw, do, dsT)), step)
    assert gs.shape == (b, h, s // step, dk, dv) and gs.dtype == torch.float32
    g, want = dsT, {}
    for tok in reversed(range(s)):
        if (tok + 1) % step == 0:
            want[tok // step] = g           # after the step ending at tok
        g = (np.exp(logw[:, tok])[..., None] * g +
             r[:, tok][..., :, None] * do[:, tok][..., None, :])
    for c in range(s // step):
        assert _err(gs[:, :, c], want[c]) <= GRAD_TOL, c
    assert torch.equal(gs[:, :, -1], torch.from_numpy(dsT).float())
    assert _err(ds0, g) <= GRAD_TOL


def test_bwd_wrapper_checks_and_cpu_route():
    t = [torch.from_numpy(a).float() for a in _inputs(1, 32, 2, 8, 8, 1.0)]
    _, s_t, states = ops.rwkv_scan_states(*t[:6], chunk=16)
    got = ops.rwkv_scan_bwd(*t[:6], states, s_t, t[6], t[7], chunk=16)
    for a, w in zip(got, ref.wkv_chunked_bwd_ref(*t, chunk=16)):
        assert torch.equal(a, w)
    with pytest.raises(ValueError, match="shaped as"):
        ops.rwkv_scan_bwd(*t[:6], states, s_t, t[6][:, :8], t[7], chunk=16)
    with pytest.raises(TypeError):
        ops.rwkv_scan_bwd(*t[:6], states, s_t, t[6].double(), t[7],
                          chunk=16)
    ops.reset_launch_counts()
    ops.rwkv_scan_with_grad(*t[:6], chunk=16)
    assert all(n == 0 for n in ops.launch_counts().values())


def test_rwkv6_layer_takes_the_training_route_under_a_gradient(monkeypatch):
    """``RWKV6LM`` reaches ``ops.rwkv_scan_with_grad`` when its params need
    a gradient (the loss) and the forward-only ``ops.rwkv_scan`` when not
    (serving), once a layer each."""
    calls = {"grad": 0, "plain": 0}
    real_grad, real_plain = ops.rwkv_scan_with_grad, ops.rwkv_scan

    def grad(*a, **kw):
        calls["grad"] += 1
        return real_grad(*a, **kw)

    def plain(*a, **kw):
        calls["plain"] += 1
        return real_plain(*a, **kw)
    monkeypatch.setattr(ops, "rwkv_scan_with_grad", grad)
    monkeypatch.setattr(ops, "rwkv_scan", plain)
    cfg = get_arch("rwkv6_3b").reduced()
    model = get_model(cfg, remat="none")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.forward(params, {"tokens": toks})
    assert calls == {"grad": 0, "plain": cfg.n_layers}
    for x in (params["layers"]["time_mix"]["wr"],):
        x.requires_grad_(True)
    loss, _ = model.loss(params, {"tokens": toks, "labels": toks})
    loss.backward()
    assert calls == {"grad": cfg.n_layers, "plain": cfg.n_layers}
