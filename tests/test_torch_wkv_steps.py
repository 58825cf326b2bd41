"""The CUDA wkv scan's arithmetic (``csrc/rwkv_scan.cu``) emulated on the
CPU: ``ref.wkv_steps_emulated`` walks the sequence in steps of up to 16
tokens, in log2 units, with the scores of a step's pairs, the output as
one product [A | r 2^cx] [v ; S] and the state update, as the kernel
does (the products as 3xTF32 at 64 x 64, as the kernel's tensor-core
instantiation computes them).  It is held against the JAX package's Pallas kernel in interpret
mode, its chunked form ``models.rwkv6.wkv_chunked`` and its per-token
oracle ``kernels.ref.wkv_ref`` on the same numpy inputs, within the JAX
package's own tolerance for its kernel: decays of -exp(N(0, 1)) and the
harsher -exp(N(0, 2)), tokens that do not decay (logw = 0), dk != dv,
steps shorter than a chunk and one step a chunk."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# the JAX package's own tolerance for its wkv kernel against its oracle
# (tests/test_kernels.py): the chunked forms reassociate exponent sums
WKV_ATOL, WKV_RTOL = 2e-4, 2e-3


def _inputs(seed, b, s, h, dk, dv, sigma, still):
    """Seeded operands; logw = -exp(N(0, sigma)), and 0 (no decay) at
    ``still`` tokens of every head."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((b, s, h, dk), dtype=np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv), dtype=np.float32)
    logw = -np.exp(sigma * rng.standard_normal((b, s, h, dk))).astype(
        np.float32)
    logw[:, list(still)] = 0.0
    u = rng.standard_normal((h, dk), dtype=np.float32)
    s0 = rng.standard_normal((b, h, dk, dv), dtype=np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("dk,dv,step,mma", [
    (64, 64, 16, True), (64, 64, 8, True), (64, 64, 12, False),
    (64, 32, 16, False), (16, 16, 16, False)])
def test_which_instantiation_uses_the_tensor_cores(dk, dv, step, mma):
    assert tref.wkv_mma_products(dk, dv, step) is mma


@pytest.mark.parametrize("chunk,step", [(32, 16), (64, 16), (16, 16),
                                        (8, 8), (24, 12), (5, 5), (1, 1)])
def test_step_tokens(chunk, step):
    assert tref.wkv_step_tokens(chunk) == step


@pytest.mark.parametrize("sigma", [1.0, 2.0])
@pytest.mark.parametrize("b,s,h,dk,dv,chunk,still", [
    (2, 64, 3, 16, 16, 32, ()),          # two steps a chunk
    (1, 64, 2, 16, 8, 16, (0, 17, 40)),  # dk != dv, undecayed tokens
    (1, 48, 2, 8, 24, 8, (7,)),          # steps of 8, dv > dk
    (2, 64, 1, 32, 32, 64, (63,)),       # four steps a chunk
    (1, 40, 1, 4, 4, 40, ()),            # chunk 40: steps of 10
    (1, 64, 2, 64, 64, 32, (5,)),        # 64 x 64: the 3xTF32 products
    (1, 32, 1, 64, 64, 8, ()),           # ... at steps of 8
])
def test_step_emulation_matches_jax_kernel_and_oracles(b, s, h, dk, dv,
                                                       chunk, still, sigma):
    """Within tolerance of the JAX per-token oracle always, and of the
    Pallas kernel and the chunked form at decays of -exp(N(0, 1)).  At
    -exp(N(0, 2)) the chunked forms lose accuracy themselves (the JAX
    kernel at chunk 64 is 1e-3 off its float64 oracle, past its own
    tolerance), so there the emulation must be no farther from the
    float64 per-token recurrence than the Pallas kernel is."""
    args = _inputs(int(10 * sigma) + dk + chunk, b, s, h, dk, dv, sigma,
                   still)
    jargs = tuple(map(jnp.asarray, args))
    o, s_t = tref.wkv_steps_emulated(*map(torch.from_numpy, args),
                                     chunk=chunk)
    assert o.shape == (b, s, h, dv) and s_t.shape == (b, h, dk, dv)
    kernel = jops.rwkv_scan(*jargs, chunk=chunk, interpret=True)
    wants = [jref.wkv_ref(*jargs)]
    if sigma == 1.0:
        wants += [kernel, jrwkv.wkv_chunked(*jargs, chunk=chunk)]
    for jo, js in wants:
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=WKV_ATOL,
                                   rtol=WKV_RTOL)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(js),
                                   atol=WKV_ATOL, rtol=WKV_RTOL)
    exact = tref.wkv_ref(*(torch.from_numpy(a).double() for a in args))
    for got, pallas, want in zip((o, s_t), kernel, exact):
        err = float((got.double() - want).abs().max())
        assert err <= max(float(np.abs(np.asarray(pallas, np.float64) -
                                       want.numpy()).max()), WKV_ATOL)


def test_step_emulation_matches_the_plain_version_on_the_smoke_decays():
    """rwkv6-3b's head width at a few heads, logw = -exp(N(0, 1)) as in
    chip_smoke.py: within the card's 1e-4 x max(1, max |plain|)."""
    args = tuple(map(torch.from_numpy, _inputs(3, 2, 128, 2, 64, 64, 1.0,
                                               ())))
    got = tref.wkv_steps_emulated(*args, chunk=32)
    want = tref.wkv_chunked_ref(*args, chunk=32)
    for g, w in zip(got, want):
        lim = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= lim
