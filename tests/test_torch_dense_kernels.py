"""The port's flash-attention and RWKV6 wkv-scan wrappers (plain versions
on the CPU) held against the JAX package's Pallas kernels in interpret
mode and its jnp oracles, on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# f32 on both sides; only the summation order differs
FLASH_TOL = 2e-5
# the JAX package's own tolerance for its wkv kernel against its oracle
# (tests/test_kernels.py): the chunked form reassociates exponent sums
WKV_ATOL, WKV_RTOL = 2e-4, 2e-3


def _qkv(seed, b, h, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, sk, d), dtype=np.float32),
            rng.standard_normal((b, hkv, sk, d), dtype=np.float32))


@pytest.mark.parametrize("b,h,hkv,s,d", [
    (2, 4, 2, 256, 64),        # GQA
    (1, 8, 1, 128, 128),       # MQA
    (2, 4, 4, 128, 64),        # MHA
    (1, 2, 1, 128, 256),       # wide heads
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_kernel_and_oracle(b, h, hkv, s, d,
                                                       causal):
    q, k, v = _qkv(0, b, h, hkv, s, s, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kernel = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal,
                                             interpret=True))
    oracle = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = tref.flash_attention_ref(tq, tk, tv, causal=causal).numpy()
    wrapped = tops.flash_attention(tq, tk, tv, causal=causal).numpy()
    np.testing.assert_array_equal(wrapped, plain)
    for want in (kernel, oracle):
        np.testing.assert_allclose(plain, want, atol=FLASH_TOL,
                                   rtol=FLASH_TOL)


@pytest.mark.parametrize("sq,sk,causal", [(7, 7, True), (11, 11, True),
                                          (7, 11, False), (11, 5, False)])
def test_flash_attention_ragged_lengths_match_jax_oracle(sq, sk, causal):
    """Lengths the Pallas kernel's blocks do not divide: the port's kernel
    masks its own ragged tail, its plain version has none."""
    q, k, v = _qkv(1, 2, 4, 2, sq, sk, 16)
    want = np.asarray(jref.flash_attention_ref(
        *map(jnp.asarray, (q, k, v)), causal=causal))
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=FLASH_TOL, rtol=FLASH_TOL)


def test_flash_attention_ref_keeps_the_oracles_causal_alignment():
    """Sq != Sk: the plain version keeps tril(Sk - Sq) like the JAX
    oracle; the wrapper refuses the case (the Pallas kernel aligns the
    mask to the top left instead)."""
    q, k, v = _qkv(2, 1, 2, 1, 5, 9, 16)
    want = np.asarray(jref.flash_attention_ref(*map(jnp.asarray, (q, k, v))))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    np.testing.assert_allclose(tref.flash_attention_ref(tq, tk, tv).numpy(),
                               want, atol=FLASH_TOL, rtol=FLASH_TOL)
    with pytest.raises(ValueError, match="Sq == Sk"):
        tops.flash_attention(tq, tk, tv, causal=True)


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    tq, tk, tv = map(torch.from_numpy, _qkv(3, 1, 4, 2, 8, 8, 16))
    with pytest.raises(TypeError):
        tops.flash_attention(tq.double(), tk, tv)
    with pytest.raises(ValueError):
        tops.flash_attention(tq, tk[:, :, :4], tv)
    with pytest.raises(ValueError):                   # H not a multiple
        tops.flash_attention(tq[:, :3], tk, tv)


def _wkv_inputs(seed, b, s, h, dk, dv):
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((b, s, h, dk), dtype=np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv), dtype=np.float32)
    logw = -np.exp(rng.standard_normal((b, s, h, dk))).astype(np.float32)
    u = rng.standard_normal((h, dk), dtype=np.float32)
    s0 = rng.standard_normal((b, h, dk, dv), dtype=np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [
    (2, 64, 3, 16, 16, 16),
    (1, 128, 2, 32, 32, 32),
    (2, 96, 1, 64, 64, 32),
])
def test_rwkv_scan_matches_jax_kernel_and_oracles(b, s, h, dk, dv, chunk):
    args = _wkv_inputs(0, b, s, h, dk, dv)
    jargs = tuple(map(jnp.asarray, args))
    targs = tuple(map(torch.from_numpy, args))
    wants = [jops.rwkv_scan(*jargs, chunk=chunk, interpret=True),
             jrwkv.wkv_chunked(*jargs, chunk=chunk), jref.wkv_ref(*jargs)]
    plain = tref.wkv_chunked_ref(*targs, chunk=chunk)
    wrapped = tops.rwkv_scan(*targs, chunk=chunk)
    per_token = tref.wkv_ref(*targs)
    for got in (plain, per_token):
        for (o, s_t), (jo, js) in ((got, w) for w in wants):
            np.testing.assert_allclose(o.numpy(), np.asarray(jo),
                                       atol=WKV_ATOL, rtol=WKV_RTOL)
            np.testing.assert_allclose(s_t.numpy(), np.asarray(js),
                                       atol=WKV_ATOL, rtol=WKV_RTOL)
    for a, w in zip(wrapped, plain):
        np.testing.assert_array_equal(a.numpy(), w.numpy())


def test_rwkv_scan_sequence_not_a_multiple_of_the_chunk_raises():
    targs = tuple(map(torch.from_numpy, _wkv_inputs(1, 1, 40, 2, 16, 16)))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tops.rwkv_scan(*targs, chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tref.wkv_chunked_ref(*targs, chunk=32)
    o, _ = tops.rwkv_scan(*targs, chunk=8)          # 40 = 5 chunks of 8
    assert o.shape == (1, 40, 2, 16)


def test_rwkv_scan_rejects_what_the_kernel_does_not_take():
    r, k, v, logw, u, s0 = map(torch.from_numpy, _wkv_inputs(2, 1, 8, 2, 16,
                                                             16))
    with pytest.raises(TypeError):
        tops.rwkv_scan(r.double(), k, v, logw, u, s0)
    with pytest.raises(ValueError):
        tops.rwkv_scan(r, k, v, logw, u[:1], s0)
    with pytest.raises(ValueError):
        tops.rwkv_scan(r, k[:, :4], v, logw, u, s0)


def test_cpu_wrappers_launch_no_kernel():
    tops.reset_launch_counts()
    tops.flash_attention(*map(torch.from_numpy, _qkv(4, 1, 2, 1, 4, 4, 16)))
    tops.rwkv_scan(*map(torch.from_numpy, _wkv_inputs(3, 1, 8, 1, 16, 16)))
    counts = tops.launch_counts()
    assert counts["flash_attention_f32"] == counts["rwkv_scan_f32"] == 0
    assert set(counts.values()) == {0}
