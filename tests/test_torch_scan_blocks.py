"""The work split of the CUDA scan (``csrc/isp_scan.cu``) emulated on the
CPU: ``ref.scan_blocks_emulated`` follows ``ref.scan_plan`` (interleaved
chunks of whole pages over the producer blocks, TMA ring units or the
direct path, the fold blocks' windows, slots and passes).  Every valid page
must be produced once and folded once, in page order, and the emulation
must equal the plain version ``ref.scan_filter_reduce_ref`` bit for bit,
and the JAX package's Pallas scan in interpret mode on the same numpy
inputs and page codes (count, min and max exactly, column sums within
1e-5, as in ``test_torch_isp_kernels.py``: the JAX scan sums a page's rows
with ``jnp.sum``, whose order is not defined).

The count is part of the page-order f32 fold: past 2^24 passing rows it
rounds as that fold does, which the two-launch design's order (16 warps
each folding every 16th page, then the warps added) did not."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import kv_tier as jkv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SUM_TOL = 1e-5        # the JAX package's in-page jnp.sum has no fixed order
_CODES = {"int8": (torch.int8, 127.0), "fp8": (torch.float8_e4m3fn, 448.0)}
_JCODES = {"int8": (jnp.int8, 127.0), "fp8": (jnp.float8_e4m3fn, 448.0)}
ELEM = {"f32": 4, "int8": 1, "fp8": 1}


def _pool(page_dtype, n_phys, page_rows, n_cols, seed=0):
    """(pages, scales) of a seeded pool, quantized as the port's
    ``kv_tier.quantize_page_kv`` does; one column is integer-valued (for
    eq/ne)."""
    from repro_torch.core.kv_tier import quantize_page_kv

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_phys, page_rows, n_cols)).astype(np.float32)
    x[:, :, n_cols // 2] = np.round(x[:, :, n_cols // 2] * 2)
    x = torch.from_numpy(x)
    if page_dtype == "f32":
        return x, None
    dtype, qmax = _CODES[page_dtype]
    return quantize_page_kv(x, qmax, dtype)


def _table(n_valid, n_phys, seed=1):
    """The valid pages shuffled, pow2-padded with an id past the pool
    (never read)."""
    rng = np.random.default_rng(seed)
    table = np.full(1 << max(n_valid - 1, 0).bit_length(), n_phys + 99,
                    np.int32)
    table[:n_valid] = rng.permutation(n_phys)[:n_valid]
    return torch.from_numpy(table)


def _plan(page_dtype, page_rows, n_cols, n_valid, n_blocks=264,
          aligned=True):
    return tref.scan_plan(n_valid, page_rows, n_cols, ELEM[page_dtype],
                          page_dtype != "f32", n_blocks, aligned)


# -- the plan -----------------------------------------------------------------


@pytest.mark.parametrize("page_dtype,page_rows,n_cols,aligned,tma", [
    ("f32", 128, 16, True, True),       # SF-1 lineitem
    ("int8", 128, 16, True, True),
    ("fp8", 128, 16, True, True),
    ("int8", 128, 24, True, True),      # the 24-column int8 store
    ("int8", 6, 16, True, False),       # scales of 6 rows: no bulk copy
    ("f32", 2048, 16, True, False),     # a page over half the ring
    ("f32", 8, 3, True, True),          # 96-byte pages
    ("fp8", 8, 33, True, False),        # 264-byte pages
    ("f32", 128, 16, False, False),     # a pool not 16-byte aligned
])
def test_scan_path_rule(page_dtype, page_rows, n_cols, aligned, tma):
    assert tref.scan_tma_path(page_rows, n_cols, ELEM[page_dtype],
                              page_dtype != "f32", aligned) is tma
    assert _plan(page_dtype, page_rows, n_cols, 100, aligned=aligned).tma \
        is tma


@pytest.mark.parametrize("page_rows", [1, 6, 8, 128, 1024, 2048])
@pytest.mark.parametrize("n_cols", [1, 3, 16, 24, 33, 176, 768])
@pytest.mark.parametrize("page_dtype", ["f32", "int8", "fp8"])
def test_scan_plan_invariants(page_dtype, page_rows, n_cols):
    n_valid = 46_885
    p = _plan(page_dtype, page_rows, n_cols, n_valid)
    assert p.chunk_pages % p.unit_pages == 0
    assert p.slot_pages % p.chunk_pages == 0
    assert p.n_chunks == -(-n_valid // p.chunk_pages)
    assert 1 <= p.n_prod <= min(264 - p.n_fold, p.n_chunks)
    assert p.vw % 4 == 0 and p.vw <= tref.SCAN_MAX_FOLD_VALUES
    assert 1 <= p.n_fold <= tref.SCAN_MAX_FOLD_BLOCKS
    assert p.chunk_pages % 4 == 0 and p.pad_pages % 4 == 0
    assert p.passes * p.n_fold * p.vw >= n_cols + 1
    windows = tref.scan_fold_windows(p, n_cols + 1)
    assert [g for w in windows for g in w] == list(range(n_cols + 1))
    assert 2 <= p.n_slots <= tref.SCAN_MAX_SLOTS
    assert p.smem <= tref.SCAN_MAX_SMEM
    if p.tma:
        assert 2 <= p.n_stages <= tref.SCAN_MAX_STAGES
        assert p.page_stride % 16 == 0
        assert p.page_stride >= page_rows * n_cols * ELEM[page_dtype]
        assert p.n_stages * p.stage_bytes <= tref.SCAN_RING_BYTES
        assert p.unit_pages * tref.SCAN_THREADS >= 1


def test_scan_plan_refuses_what_no_block_fits():
    tref.scan_plan(10, 1, 15_000, 4, False, 264)
    with pytest.raises(ValueError, match="columns"):
        tref.scan_plan(10, 1, 17_000, 4, False, 264)


# -- every page once, folded in page order -------------------------------------

# (page type, page_rows, n_cols): the lineitem page geometry at one column
# (so 46,885 pages stay small on the CPU) and small pages of 16 columns
GEOMETRIES = [("f32", 128, 1), ("int8", 8, 16)]


def _n_valid_cases(page_dtype, page_rows, n_cols):
    chunk = _plan(page_dtype, page_rows, n_cols, 1).chunk_pages
    return sorted({1, 2, chunk - 1, chunk, chunk + 1, 46_885} - {0})


@pytest.mark.parametrize("n_blocks", [1, 132, 264])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=str)
def test_every_valid_page_folded_once_in_order(geometry, n_blocks):
    page_dtype, page_rows, n_cols = geometry
    for n_valid in _n_valid_cases(*geometry):
        if page_dtype != "f32" and n_valid > 5000:
            continue        # the f32 geometry covers 46,885 pages
        pages, scales = _pool(page_dtype, n_valid + 2, page_rows, n_cols,
                              seed=n_valid)
        table = _table(n_valid, n_valid + 2, seed=n_valid)
        n_rows = n_valid * page_rows - page_rows // 3
        trace = {}
        got = tref.scan_blocks_emulated(pages, table, n_rows, 0.1,
                                        scales=scales, filter_op="ge",
                                        n_blocks=n_blocks, trace=trace)
        plan = trace["plan"]
        assert plan.n_prod == max(1, min(n_blocks - plan.n_fold,
                                         plan.n_chunks))
        # page p is produced once, by the block of its chunk
        assert trace["producer"] == [
            (p // plan.chunk_pages) % plan.n_prod for p in range(n_valid)]
        units = trace["units"]
        assert sum(n for *_, n in units) == n_valid
        assert all(n <= plan.unit_pages for *_, n in units)
        # a block's units go in chunk order, and its chunks interleave
        for b in range(plan.n_prod):
            mine = [c for bb, c, _, _ in units if bb == b]
            assert mine == sorted(mine)
            assert all(c % plan.n_prod == b for c in mine)
        windows = tref.scan_fold_windows(plan, n_cols + 1)
        assert sorted(g for w in windows for g in w) == list(range(n_cols + 1))
        assert trace["folded"] == [list(range(n_valid))] * len(windows)
        want = tref.scan_filter_reduce_ref(pages, table, n_rows, 0.1,
                                           scales=scales, filter_op="ge")
        assert torch.equal(got, want), n_valid


# -- bit for bit against the plain version -------------------------------------

SHAPES = [(pr, c) for pr in (1, 6, 8, 128, 1024, 2048)
          for c in (1, 3, 16, 24, 33, 176)]


@pytest.mark.parametrize("page_dtype", ["f32", "int8", "fp8"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_emulation_equals_plain_at_every_shape(shape, page_dtype):
    page_rows, n_cols = shape
    i = SHAPES.index(shape) + 7 * ("f32", "int8", "fp8").index(page_dtype)
    # a few pages (fewer for wide big pages), the last one partial; every
    # eleventh case has no row at all
    n_valid = 1 + i % (3 if page_rows * n_cols > 20_000 else 9)
    n_rows = 0 if i % 11 == 0 else n_valid * page_rows - i % page_rows
    n_valid = max(1, -(-n_rows // page_rows))
    pages, scales = _pool(page_dtype, n_valid + 3, page_rows, n_cols, i)
    table = _table(n_valid, n_valid + 3, i)
    op = tref.FILTER_OPS[i % 5]
    col = i % n_cols
    thr = 0.0 if op in ("eq", "ne") else 0.25
    for n_blocks in (1, 3, 264):
        for aligned in (True, False):
            got = tref.scan_blocks_emulated(
                pages, table, n_rows, thr, scales=scales, filter_col=col,
                filter_op=op, n_blocks=n_blocks, aligned=aligned)
            want = tref.scan_filter_reduce_ref(
                pages, table, n_rows, thr, scales=scales, filter_col=col,
                filter_op=op)
            assert torch.equal(got, want), (n_blocks, aligned)


@pytest.mark.parametrize("op", ["all", "ge", "lt", "eq", "ne"])
@pytest.mark.parametrize("page_dtype", ["f32", "int8", "fp8"])
def test_emulation_equals_plain_every_filter(page_dtype, op):
    """The lineitem page geometry (128 x 16) on both paths, a
    pow2-padded table, the last page partial, and an empty extent."""
    pages, scales = _pool(page_dtype, 40, 128, 16, seed=3)
    table = _table(37, 40, seed=4)
    thr = 0.0 if op in ("eq", "ne") else -0.2
    for n_rows in (37 * 128 - 51, 0):
        for aligned in (True, False):
            got = tref.scan_blocks_emulated(
                pages, table, n_rows, thr, scales=scales, filter_col=8,
                filter_op=op, n_blocks=5, aligned=aligned)
            want = tref.scan_filter_reduce_ref(
                pages, table, n_rows, thr, scales=scales, filter_col=8,
                filter_op=op)
            assert torch.equal(got, want)
    host = tref.scan_filter_reduce_host(
        tref.pool_rows(pages, scales, table[:37].long()).reshape(
            -1, 16)[:37 * 128 - 51], thr, page_rows=128, filter_col=8,
        filter_op=op)
    assert torch.equal(tref.scan_blocks_emulated(
        pages, table, 37 * 128 - 51, thr, scales=scales, filter_col=8,
        filter_op=op, n_blocks=5), host)


# -- against the JAX scan -------------------------------------------------------


def _jax_pool(page_dtype, n_phys, page_rows, n_cols, seed):
    """The same pool for both packages: the JAX package's quantizer makes
    the codes, which the port reads as its own."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_phys, page_rows, n_cols)).astype(np.float32)
    x[:, :, 1] = np.round(x[:, :, 1] * 2)
    if page_dtype == "f32":
        return (jnp.asarray(x), None), (torch.from_numpy(x), None)
    code, qmax = _JCODES[page_dtype]
    codes, scale = jkv.quantize_page_kv(jnp.asarray(x), qmax, code)
    raw = np.asarray(codes).view(np.uint8 if page_dtype == "fp8"
                                 else np.int8)
    t_codes = torch.from_numpy(raw.copy())
    if page_dtype == "fp8":
        t_codes = t_codes.view(torch.float8_e4m3fn)
    return ((codes, scale),
            (t_codes, torch.from_numpy(np.asarray(scale).copy())))


@pytest.mark.parametrize("op,col,thr", [("all", 0, 0.0), ("ge", 2, 0.1),
                                        ("lt", 5, -0.3), ("eq", 1, 0.0),
                                        ("ne", 1, 1.0)])
@pytest.mark.parametrize("page_dtype", ["f32", "int8", "fp8"])
def test_emulation_matches_pallas(page_dtype, op, col, thr):
    (jp, js), (tp, ts) = _jax_pool(page_dtype, 24, 16, 16, seed=6)
    table = np.array([3, 7, 1, 9, 10, 0, 22, 13, 5, 17, 2, 4, 4, 4, 4, 4],
                     np.int32)
    n_rows = 11 * 16 - 5
    want = np.asarray(jops.scan_filter_reduce(
        jp, jnp.asarray(table), n_rows, thr, scales=js, filter_col=col,
        filter_op=op, interpret=True))
    for n_blocks in (1, 2, 264):
        got = tref.scan_blocks_emulated(
            tp, torch.from_numpy(table), n_rows, thr, scales=ts,
            filter_col=col, filter_op=op, n_blocks=n_blocks).numpy()
        np.testing.assert_array_equal(got[[0, 2, 3, 4, 5, 6, 7]],
                                      want[[0, 2, 3, 4, 5, 6, 7]])
        np.testing.assert_allclose(got[1], want[1], rtol=SUM_TOL,
                                   atol=SUM_TOL)


# -- C3: the count past 2^24 -----------------------------------------------------


def _two_pass_order(counts):
    """The counts folded in the two-launch design's order: warp w of 16
    adds pages w, w + 16, ... in order from 0, then the warps' sums are
    added in warp order, in f32."""
    warps = np.array([np.add.accumulate(counts[w::16])[-1]
                      for w in range(16)], np.float32)
    return np.add.accumulate(warps)[-1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_count_past_2_24_is_the_page_order_fold(seed):
    """An SF-10 lineitem extent (59,986,052 rows on 128-row pages) with a
    filter passing about half its rows: per-page counts, about half of
    them odd, summing past 2^24.  The fold blocks' fold equals numpy's
    sequential accumulate (the plain fold) bit for bit; the two-launch
    order does not."""
    rows, page_rows = 59_986_052, 128
    n_pages = -(-rows // page_rows)
    rng = np.random.default_rng(seed)
    counts = rng.binomial(page_rows, 0.5, n_pages).astype(np.float32)
    counts[-1] = rng.binomial(rows - (n_pages - 1) * page_rows, 0.5)
    sums = rng.normal(size=n_pages).astype(np.float32)
    part = np.stack([counts, sums], axis=1)
    assert (counts % 2 == 1).mean() > 0.4
    assert counts.astype(np.int64).sum() > 2 ** 24
    want = np.add.accumulate(part, axis=0)[-1]
    np.testing.assert_array_equal(tref.fold_page_partials(part), want)
    for n_blocks in (1, 132, 264):
        plan = _plan("f32", page_rows, 1, n_pages, n_blocks)
        trace = {}
        got = tref.scan_follow_emulated(part, plan, trace)
        np.testing.assert_array_equal(got, want)
        assert trace["folded"] == [list(range(n_pages))]
    # f32 rounding shows: the page-order count is not the integer count,
    # and the two-launch order lands elsewhere
    assert int(want[0]) != int(counts.astype(np.int64).sum())
    assert _two_pass_order(counts) != want[0]
