"""The embedding kernels' split (``ref.embed_plan``) and its CPU
emulations, and every table dtype the JAX package's embedding kernels
take, through the port.

The bag's adds are fixed (lookup order from 0, each code widened to f32,
each product rounded before its add), so the port's plain version, its
emulation of the CUDA kernel's lanes and the JAX kernel in interpret
mode agree: the emulation bit for bit, the JAX kernel within the 1e-6 of
``test_torch_isp_kernels.py::test_embed_agg_matches_pallas``.  Gathers
copy bytes and match bit for bit, the dtype kept."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import embed_agg as emb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

AGG_TOL = 1e-6
DIMS = (1, 2, 3, 4, 6, 24, 64, 128, 768, 1000)
LOOKUPS = (1, 16, 33, 100)
JAX_OF = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
          torch.int8: jnp.int8, torch.float32: jnp.float32,
          torch.float8_e4m3fn: jnp.float8_e4m3fn}


def _table(dtype, v, d, seed):
    """[V, D] of ``dtype`` from a seeded numpy generator: f32 values of
    N(0, 4) converted (fp8 e4m3 within its range), integers over the
    dtype's range (int32: past 2^24, where the widening rounds)."""
    rng = np.random.default_rng(seed)
    if dtype.is_floating_point:
        x = torch.from_numpy(rng.normal(0.0, 4.0, (v, d)).astype(np.float32))
        return x.to(dtype)
    info = torch.iinfo(dtype)
    lo, hi = max(info.min, -2**30), min(info.max, 2**30)
    return torch.from_numpy(rng.integers(lo, hi, (v, d), endpoint=True)
                            ).to(dtype)


def _bits(x):
    return x.contiguous().view(torch.uint8)


# -- C4: every table dtype the JAX kernels take, against the JAX package --


def _folds(table, idx, w):
    """The bag in numpy: each product rounded to f32 before its add (the
    port's order), and each product fused into its add (one rounding a
    step: f32(f64(acc) + f64(row) * f64(w)), the product exact in f64)."""
    rounded = np.zeros((idx.shape[0], table.shape[1]), np.float32)
    fused = rounded.copy()
    for li in range(idx.shape[1]):
        row = table[idx[:, li]]
        if w is None:
            rounded = rounded + row
            fused = fused + row
        else:
            wl = w[:, li, None]
            rounded = rounded + row * wl
            fused = (fused.astype(np.float64) + row.astype(np.float64) *
                     wl.astype(np.float64)).astype(np.float32)
    return rounded, fused


@pytest.mark.parametrize("wdtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.int8])
def test_embed_agg_table_dtypes_match_pallas(dtype, wdtype):
    """f32 output from bf16, f16 and int8 tables and f32 or bf16 weights.
    The port adds each rounded product (its plain version's order) and
    equals that fold bit for bit; the JAX kernel, traced by XLA on the
    CPU, fuses each product into its add and equals the fused fold bit
    for bit.  The two agree within 1e-6, except int8 codes (up to 127)
    with f32 weights, where sums of ~10^3 put one step's rounding above
    it: there each side is held to its own fold exactly."""
    table = _table(dtype, 48, 24, seed=11)
    rng = np.random.default_rng(12)
    idx = rng.integers(0, 48, (5, 16), dtype=np.int32)
    w = None if wdtype is None else torch.from_numpy(
        rng.uniform(0.5, 2.0, (5, 16)).astype(np.float32)).to(wdtype)
    jw = None if w is None else jnp.asarray(w.float().numpy()).astype(
        JAX_OF[wdtype])
    want = np.asarray(jops.embed_agg(
        jnp.asarray(table.float().numpy()).astype(JAX_OF[dtype]),
        jnp.asarray(idx), jw))
    got = tops.embed_agg(table, torch.from_numpy(idx), w)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    rounded, fused = _folds(table.float().numpy(), idx,
                            None if w is None else w.float().numpy())
    np.testing.assert_array_equal(got.numpy(), rounded)
    np.testing.assert_array_equal(want, fused)
    if not (dtype == torch.int8 and wdtype == torch.float32):
        np.testing.assert_allclose(got.numpy(), want, rtol=AGG_TOL,
                                   atol=AGG_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8,
                                   torch.float16, torch.float8_e4m3fn])
def test_embed_gather_keeps_dtype_bit_for_bit(dtype):
    table = _table(dtype, 40, 12, seed=13)
    idx = np.random.default_rng(14).integers(0, 40, (3, 5), dtype=np.int32)
    want = jops.embed_gather(
        jnp.asarray(table.float().numpy()).astype(JAX_OF[dtype]),
        jnp.asarray(idx))
    got = tops.embed_gather(table, torch.from_numpy(idx))
    assert got.dtype == dtype and got.shape == (3, 5, 12)
    np.testing.assert_array_equal(_bits(got).numpy(),
                                  np.asarray(want).view(np.uint8)
                                  .reshape(_bits(got).shape))


# -- the plan --------------------------------------------------------------


@pytest.mark.parametrize("elem", [1, 2, 4, 8])
@pytest.mark.parametrize("d", DIMS)
def test_embed_plan_covers_each_row_byte_once(elem, d):
    for align in (a for a in (1, 2, 4, 8, 16) if a % elem == 0):
        plan = ref.embed_plan(elem, d, align)
        row = elem * d
        assert row % plan.vec == 0 and align % plan.vec == 0
        assert plan.vec >= elem and plan.vec <= ref.EMBED_MAX_PIECE
        assert plan.lanes in (8, 16, 32) and plan.lanes >= ref.EMBED_STAGE_ROWS
        assert plan.slices == 1 or plan.lanes == ref.EMBED_SLICE_PIECES
        seen = np.zeros(row, np.int32)
        for s, q, lo, hi in ref.embed_lane_pieces(plan):
            assert 0 <= q < plan.lanes and 0 <= s < plan.slices
            assert hi - lo == plan.vec and lo % plan.vec == 0
            seen[lo:hi] += 1
        assert (seen == 1).all()
        assert ref.embed_blocks(plan, 7) * ref.EMBED_BLOCK_THREADS >= \
            7 * plan.slices * plan.lanes


def test_embed_plan_widest_piece():
    """16-byte pieces where row and base allow; D = 64 f32 is 16 lanes a
    row (two bags a warp); D = 768 f32 six slices of 32 pieces."""
    assert ref.embed_plan(4, 128, 16) == (16, 32, 32, 1, 8)
    assert ref.embed_plan(4, 64, 16) == (16, 16, 16, 1, 8)
    assert ref.embed_plan(4, 768, 16) == (16, 192, 32, 6, 8)
    assert ref.embed_plan(2, 128, 16).vec == 16
    assert ref.embed_plan(4, 3, 4) == (4, 3, 8, 1, 8)
    assert ref.embed_plan(1, 1000, 16).vec == 8
    with pytest.raises(ValueError):
        ref.embed_plan(4, 8, 2)            # rows not aligned to elements


@pytest.mark.parametrize("dtype", emb.AGG_DTYPES)
def test_embed_align_follows_views(dtype):
    """A view's base and row stride set the piece: table[1:] at D = 3,
    and a column slice whose row stride is the parent's."""
    table = _table(dtype, 9, 3, seed=1)
    es = table.element_size()
    view = table[1:]
    align = ref.embed_align(view)
    assert view.data_ptr() % align == 0 and (3 * es) % align == 0
    assert align == np.gcd(np.gcd(view.data_ptr(), 3 * es), 16)
    assert emb.plan_of(view).vec == np.gcd(3 * es, align)
    wide = _table(dtype, 9, 128, seed=2)
    part = wide[:, 8:72]
    assert part.stride(0) == 128
    assert emb.plan_of(part).vec == np.gcd(
        np.gcd(64 * es, 16), ref.embed_align(part))


# -- the emulation of the kernels' lanes -------------------------------------


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("dtype", emb.AGG_DTYPES)
def test_embed_agg_emulated_is_the_plain_version(dtype, d):
    table = _table(dtype, 41, d, seed=d)
    rng = np.random.default_rng(d + 1)
    for n_look in LOOKUPS:
        idx = torch.from_numpy(rng.integers(0, 40, (3, n_look),
                                            dtype=np.int32))
        w = torch.from_numpy(rng.uniform(0.5, 2.0, (3, n_look))
                             .astype(np.float32))
        for weights in (None, w, w.to(torch.bfloat16)):
            for t in (table, table[1:]):      # the view: another alignment
                got = ref.embed_agg_emulated(t, idx, weights)
                want = ref.embed_agg_ref(t, idx, weights)
                assert torch.equal(_bits(got), _bits(want)), \
                    (dtype, d, n_look, weights is not None)


@pytest.mark.parametrize("dtype", emb.AGG_DTYPES)
def test_embed_agg_emulated_column_slice(dtype):
    """A table whose row stride is not its width (a column slice)."""
    part = _table(dtype, 30, 128, seed=5)[:, 8:72]
    idx = torch.from_numpy(np.random.default_rng(6).integers(
        0, 30, (4, 33), dtype=np.int32))
    got = ref.embed_agg_emulated(part, idx)
    assert torch.equal(_bits(got), _bits(ref.embed_agg_ref(part, idx)))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                   torch.bfloat16, torch.int8,
                                   torch.float8_e4m3fn, torch.float8_e5m2,
                                   torch.float16, torch.float64,
                                   torch.int64])
def test_embed_gather_emulated_is_the_plain_version(dtype):
    for d in DIMS:
        table = _table(dtype, 21, d, seed=d)
        idx = torch.from_numpy(np.random.default_rng(d).integers(
            0, 20, (8, 4), dtype=np.int32))
        for t in (table, table[1:]):
            got = ref.embed_gather_emulated(t, idx)
            assert got.dtype == dtype and got.shape == (8, 4, d)
            assert torch.equal(_bits(got), _bits(ref.embed_gather_ref(t, idx)))


# -- what the card path takes -------------------------------------------------


@pytest.mark.parametrize("dtype", emb.AGG_DTYPES)
def test_kernel_takes_every_reference_table_dtype(dtype):
    table = _table(dtype, 16, 64, seed=3)
    for weights in (None, torch.ones(2, 3), torch.ones(2, 3).bfloat16(),
                    torch.ones(2, 3).half(), torch.ones(2, 3).double()):
        assert emb.kernel_takes(table, weights) == \
            f"{str(dtype)[6:]}_v16"
    assert emb.kernel_takes(table, gather=True) == "gather_v16"
    view = table[1:, :3]
    assert emb.kernel_takes(view) == \
        f"{str(dtype)[6:]}_v{emb.plan_of(view).vec}"


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                   torch.bfloat16, torch.int8,
                                   torch.float8_e4m3fn, torch.float16,
                                   torch.float64, torch.int64, torch.bool])
def test_kernel_takes_gathers_of_any_dtype(dtype):
    table = torch.zeros((10, 64), dtype=dtype)
    assert emb.kernel_takes(table, gather=True) == "gather_v16"
    view = table[1:, :3]
    assert emb.kernel_takes(view, gather=True) == \
        f"gather_v{emb.plan_of(view).vec}"


@pytest.mark.parametrize("call,err", [
    (lambda: emb.kernel_takes(torch.zeros(2, 3, 4)), ValueError),
    (lambda: emb.kernel_takes(torch.zeros(8, 4).t()), ValueError),
    (lambda: emb.kernel_takes(torch.zeros(8, 4, dtype=torch.float64)),
     TypeError),
    (lambda: emb.kernel_takes(torch.zeros(8, 4),
                              torch.zeros(2, 2, dtype=torch.complex64)),
     TypeError),
])
def test_kernel_takes_raises_only_where_no_kernel_reads(call, err):
    with pytest.raises(err):
        call()
