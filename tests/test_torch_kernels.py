"""The port's paged-attention wrappers (plain versions on the CPU) and
page quantizer, held against the JAX package's Pallas kernels in
interpret mode and its quantizer, on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import kv_tier as jkv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import kv_tier as tkv  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

# f32 on both sides; only the summation order differs
TOL = 1e-5


def _paged_inputs(seed, b, h, hkv, d, page, n_phys, pps, lengths):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((n_phys, page, hkv, d)).astype(np.float32)
    v = rng.standard_normal((n_phys, page, hkv, d)).astype(np.float32)
    table = np.zeros((b, pps), np.int32)
    for i, n in enumerate(lengths):
        used = -(-n // page)
        # distinct live pages; the padded tail of each row stays page 0
        table[i, :used] = rng.choice(n_phys, used, replace=False)
    return q, k, v, table, np.asarray(lengths, np.int32)


CASES = [  # (H, Hkv, lengths): GQA groups 1/2/4, ragged, a zero row
    (4, 4, [0, 1, 7, 8, 9, 31]),
    (4, 2, [5, 16, 0, 23]),
    (8, 2, [32, 1, 17, 0, 3, 12, 30, 2]),
]


@pytest.mark.parametrize("h,hkv,lengths", CASES)
def test_paged_attention_matches_pallas(h, hkv, lengths):
    d, page, n_phys, pps = 16, 8, 24, 8       # pps padded past the need
    q, k, v, table, lens = _paged_inputs(0, len(lengths), h, hkv, d, page,
                                         n_phys, pps, lengths)
    want = np.asarray(jops.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lens), interpret=True))
    got = tops.paged_attention(*map(torch.from_numpy, (q, k, v, table, lens)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert not got[np.asarray(lengths) == 0].any()   # zero rows stay zero


@pytest.mark.parametrize("page_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("h,hkv,lengths", CASES)
def test_paged_attention_q8_matches_pallas(page_dtype, h, hkv, lengths):
    d, page, n_phys, pps = 16, 8, 24, 8
    q, k, v, table, lens = _paged_inputs(1, len(lengths), h, hkv, d, page,
                                         n_phys, pps, lengths)
    code, qmax = tkv._CODE[page_dtype]
    kq, ks = tkv.quantize_page_kv(torch.from_numpy(k), qmax, code)
    vq, vs = tkv.quantize_page_kv(torch.from_numpy(v), qmax, code)
    jcode = jnp.int8 if page_dtype == "int8" else jnp.float8_e4m3fn
    # the codes cross to JAX as bytes, reinterpreted on its side
    jk = jax.lax.bitcast_convert_type(jnp.asarray(kq.view(torch.uint8).numpy()),
                                      jcode)
    jv = jax.lax.bitcast_convert_type(jnp.asarray(vq.view(torch.uint8).numpy()),
                                      jcode)
    want = np.asarray(jops.paged_attention_q8(
        jnp.asarray(q), jk, jv, jnp.asarray(ks.numpy()),
        jnp.asarray(vs.numpy()), jnp.asarray(table), jnp.asarray(lens),
        interpret=True))
    got = tops.paged_attention_q8(torch.from_numpy(q), kq, vq, ks, vs,
                                  torch.from_numpy(table),
                                  torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("page_dtype", ["int8", "fp8"])
def test_quantize_page_kv_bit_identical(page_dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((64, 4, 16)) *
         rng.uniform(0.01, 10.0, (64, 4, 1))).astype(np.float32)
    x[3, 1] = 0.0                                  # all-zero slot: clamped scale
    x[5, 2, :8] = 0.5                              # ties for round-half-even
    code, qmax = tkv._CODE[page_dtype]
    jcode = jnp.int8 if page_dtype == "int8" else jnp.float8_e4m3fn
    jq, js = jkv.quantize_page_kv(jnp.asarray(x), qmax, jcode)
    tq, ts = tkv.quantize_page_kv(torch.from_numpy(x), qmax, code)
    np.testing.assert_array_equal(
        tq.view(torch.uint8).numpy(),
        np.asarray(jax.lax.bitcast_convert_type(jq, jnp.uint8)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tkv.dequantize_page_kv(tq, ts).numpy(),
        np.asarray(jkv.dequantize_page_kv(jq, js)))


def test_wrappers_reject_what_the_kernel_does_not_take():
    q, k, v, table, lens = _paged_inputs(3, 2, 4, 2, 16, 8, 4, 2, [3, 9])
    args = list(map(torch.from_numpy, (q, k, v, table, lens)))
    with pytest.raises(TypeError):
        tops.paged_attention(args[0].double(), *args[1:])
    with pytest.raises(TypeError):
        tops.paged_attention(*args[:3], args[3].long(), args[4])
    with pytest.raises(ValueError):
        tops.paged_attention(args[0][:1], *args[1:])
    with pytest.raises(TypeError):      # f32 pages into the q8 wrapper
        tops.paged_attention_q8(args[0], args[1], args[2],
                                torch.ones(4, 8, 2), torch.ones(4, 8, 2),
                                args[3], args[4])


def test_cpu_wrappers_launch_no_kernel():
    tops.reset_launch_counts()
    q, k, v, table, lens = _paged_inputs(4, 2, 4, 2, 16, 8, 4, 2, [3, 9])
    tops.paged_attention(*map(torch.from_numpy, (q, k, v, table, lens)))
    assert set(tops.launch_counts().values()) == {0}
