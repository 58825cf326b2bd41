"""The split of the CUDA top-k (``csrc/isp_scan.cu``) emulated on the CPU:
``ref.topk_blocks_emulated`` cuts the valid pages into units of at most
256 rows and the units into contiguous block ranges, keeps a per-block
candidate buffer behind the running k-th best and merges the blocks'
sorted lists a position at a time, as the kernel does.  It must equal the plain version ``ref.topk_scan_ref`` bit for bit
and the JAX package's Pallas top-k in interpret mode on the same numpy
inputs and page codes (row ids exactly, scores within 1e-6 relative as
in ``test_torch_isp_kernels.py``)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import kv_tier as jkv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import isp_scan as tisp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SCORE_RTOL = 1e-6
N_PHYS, PAGE_ROWS, N_COLS = 320, 8, 16
N_VALID = 299                       # at least 264 pages: one a block
N_ROWS = N_VALID * PAGE_ROWS - 3    # the last page ends mid-page
# copies of one row in different blocks at every split below (ties are
# broken on the row id); 1191 | 1192 straddles the two-block boundary
# (page 148 | 149)
DUP_ROWS = (5, 1191, 1192, 2388)
_CODES = {"int8": (jnp.int8, 127.0), "fp8": (jnp.float8_e4m3fn, 448.0)}


def _table():
    """The valid pages in a shuffled order, pow2-padded with an id past
    the pool (never read)."""
    rng = np.random.default_rng(11)
    table = np.full(512, 10_000, np.int32)
    table[:N_VALID] = rng.permutation(N_PHYS)[:N_VALID]
    return table


def _pool(page_dtype):
    """(JAX operands, port operands, query) over a pool whose logical rows
    DUP_ROWS are one row; the query is that row (longer: it wins dot)."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(N_PHYS, PAGE_ROWS, N_COLS)).astype(np.float32)
    table = _table()
    src = x[table[DUP_ROWS[0] // PAGE_ROWS], DUP_ROWS[0] % PAGE_ROWS] * 3
    for r in DUP_ROWS:
        x[table[r // PAGE_ROWS], r % PAGE_ROWS] = src
    q = src.copy()
    if page_dtype == "f32":
        return (jnp.asarray(x), None), (torch.from_numpy(x), None), q
    code, qmax = _CODES[page_dtype]
    codes, scale = jkv.quantize_page_kv(jnp.asarray(x), qmax, code)
    raw = np.asarray(codes).view(np.uint8 if page_dtype == "fp8"
                                 else np.int8)
    t_codes = torch.from_numpy(raw.copy())
    if page_dtype == "fp8":
        t_codes = t_codes.view(torch.float8_e4m3fn)
    return ((codes, scale), (t_codes, torch.from_numpy(
        np.asarray(scale).copy())), q)


@functools.lru_cache(maxsize=None)
def _jax_topk(page_dtype, k, metric, n_rows=N_ROWS):
    (jp, js), _, q = _pool(page_dtype)
    return np.asarray(jops.topk_scan(jp, jnp.asarray(_table()), n_rows,
                                     jnp.asarray(q)[None, :], k=k,
                                     metric=metric, scales=js,
                                     interpret=True))


@pytest.mark.parametrize("n_blocks", [1, 2, 7, 264])
@pytest.mark.parametrize("metric", ["dot", "cosine"])
@pytest.mark.parametrize("k", [1, 4, 128])
@pytest.mark.parametrize("page_dtype", ["f32", "int8", "fp8"])
def test_block_split_equals_plain_and_pallas(page_dtype, k, metric,
                                             n_blocks):
    _, (tp, ts), q = _pool(page_dtype)
    table = torch.from_numpy(_table())
    query = torch.from_numpy(q)
    stats = {}
    got = tref.topk_blocks_emulated(tp, table, N_ROWS, query, k=k,
                                    metric=metric, scales=ts,
                                    n_blocks=n_blocks, stats=stats)
    plain = tref.topk_scan_ref(tp, table, N_ROWS, query, k=k,
                               metric=metric, scales=ts)
    assert torch.equal(got, plain)
    want = _jax_topk(page_dtype, k, metric)
    got = got.numpy()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=SCORE_RTOL, atol=0)
    # the planted copies come first, in row-id order, across blocks
    assert list(got[1, :min(k, 4)]) == [float(r) for r in DUP_ROWS[:k]]
    assert stats["flushes"] >= n_blocks       # every block sorted its list


@pytest.mark.parametrize("sort_cap", [160, 256])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("page_dtype", ["f32", "int8", "fp8"])
def test_small_candidate_buffer_sorts_in_mid_block(page_dtype, k,
                                                   sort_cap):
    """A buffer that fills every few pages (no sort before it is full):
    blocks sort candidates in while streaming, and the result does not
    change."""
    _, (tp, ts), q = _pool(page_dtype)
    table = torch.from_numpy(_table())
    query = torch.from_numpy(q)
    stats = {}
    got = tref.topk_blocks_emulated(tp, table, N_ROWS, query, k=k,
                                    scales=ts, n_blocks=2,
                                    sort_cap=sort_cap, flush_at=10 ** 9,
                                    stats=stats)
    assert stats["buffer_full"] >= 2          # at least once a block
    assert torch.equal(got, tref.topk_scan_ref(tp, table, N_ROWS, query,
                                               k=k, scales=ts))


@pytest.mark.parametrize("k", [1, 4, 128])
@pytest.mark.parametrize("page_dtype", ["f32", "int8", "fp8"])
def test_kernel_flush_rule_sorts_early_and_small(page_dtype, k):
    """The kernel's rule (sort once max(k, 32) candidates gathered): every
    block sorts mid-stream, no sort is of a full buffer, and the result
    does not change."""
    _, (tp, ts), q = _pool(page_dtype)
    table = torch.from_numpy(_table())
    query = torch.from_numpy(q)
    stats = {}
    got = tref.topk_blocks_emulated(tp, table, N_ROWS, query, k=k,
                                    scales=ts, n_blocks=2, stats=stats)
    assert stats["stream_flushes"] >= 2 and stats["buffer_full"] == 0
    assert torch.equal(got, tref.topk_scan_ref(tp, table, N_ROWS, query,
                                               k=k, scales=ts))


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
@pytest.mark.parametrize("page_dtype", ["f32", "int8", "fp8"])
def test_blocks_with_fewer_rows_than_k(page_dtype, n_blocks):
    """20 rows in 3 pages, k = 128: every block holds fewer rows than k,
    the empty slots stay (-1e30, 2^30)."""
    _, (tp, ts), q = _pool(page_dtype)
    table = torch.from_numpy(_table())
    query = torch.from_numpy(q)
    got = tref.topk_blocks_emulated(tp, table, 20, query, k=128,
                                    scales=ts, n_blocks=n_blocks)
    assert torch.equal(got, tref.topk_scan_ref(tp, table, 20, query,
                                               k=128, scales=ts))
    want = _jax_topk(page_dtype, 128, "dot", n_rows=20)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert (got[1, 20:128] == 2.0 ** 30).all()
    assert (got[0, 20:128] == np.float32(-1e30)).all()


@pytest.mark.parametrize("shape,dtype,scaled,path", [
    ((4, 8, 15), torch.float32, False, "direct"),     # 60-byte rows
    ((4, 8, 24), torch.int8, True, "direct"),         # 24-byte rows
    ((4, 257, 16), torch.float32, False, "tma"),      # two units a page
    ((4, 6, 16), torch.int8, True, "direct"),         # 6-row code pages
    ((4, 2048, 768), torch.int8, True, "tma"),        # the re-paged corpus
])
def test_topk_pool_check_names_what_the_kernel_does_not_take(shape, dtype,
                                                             scaled, path):
    """The pools the check refused before the kernel took them: it now
    names the path that takes each, and raises for none."""
    pages = torch.zeros(shape, dtype=dtype)
    scales = torch.ones(shape[:2]) if scaled else None
    assert tisp.check_topk_pool(pages, scales, torch.zeros(shape[2])) == path


def test_topk_pool_check_unaligned_query_takes_the_direct_path():
    pages = torch.zeros((4, 128, 16))
    query = torch.zeros(17)[1:]                # 4 bytes past 16-byte aligned
    assert query.data_ptr() % 16
    assert tisp.check_topk_pool(pages, None, query) == "direct"


@pytest.mark.parametrize("page_rows,n_valid,path,units", [
    (8, 299, "tma", 299), (256, 3, "tma", 3), (257, 3, "tma", 6),
    (512, 5, "tma", 10), (2048, 2, "tma", 16), (6, 7, "direct", 1),
    (6, 300, "direct", 8), (8, 299, "direct", 10), (32, 9, "direct", 2),
    (128, 5, "direct", 3), (129, 5, "direct", 5), (300, 4, "direct", 8)])
def test_topk_units(page_rows, n_valid, path, units):
    """A page of more than 256 rows is several units; on the direct path
    pages of up to 128 rows go 256 rows' worth of whole pages a unit."""
    assert tref.topk_units(n_valid, page_rows, path == "tma") == units


@pytest.mark.parametrize("shape,dtype,scaled", [
    ((4, 128, 768), torch.float32, False), ((4, 128, 768), torch.int8, True),
    ((4, 128, 16), torch.int8, True), ((4, 128, 16), torch.float32, False),
])
def test_topk_pool_check_takes_the_served_pools(shape, dtype, scaled):
    """The retrieval corpus (768 columns) and the lineitem extent (16)
    on every page format, page 128: the TMA ring."""
    pages = torch.zeros(shape, dtype=dtype)
    scales = torch.ones(shape[:2]) if scaled else None
    assert tisp.check_topk_pool(pages, scales,
                                torch.zeros(shape[2])) == "tma"


# (page_rows, n_cols, page type, n_valid, n_rows): pages of several
# units (512 and 2,048 rows; 300, a short last unit), an int8 store of 24
# columns (rows no tensor map describes), quantized pages of 6 rows
# (scales loaded row by row), an fp8 store of 24 columns on 6-row pages
POOL_SHAPES = [(512, 16, "f32", 5, 5 * 512 - 100),
               (2048, 8, "int8", 3, 3 * 2048 - 7),
               (2048, 16, "f32", 2, 2 * 2048),
               (300, 16, "fp8", 4, 4 * 300 - 31),
               (96, 24, "int8", 40, 40 * 96 - 5),
               (6, 16, "int8", 300, 300 * 6 - 1),
               (6, 24, "fp8", 200, 200 * 6 - 4)]


@functools.lru_cache(maxsize=None)
def _shaped_pool(page_rows, n_cols, page_dtype, n_valid, n_rows):
    """(JAX operands, port operands, query, table) of a shuffled pool of
    n_valid + 3 pages; copies of one row at the first row, at the last
    row of the first unit and the first of the second (or of the second
    page), and at the last valid row; the query is that row (longer:
    it wins dot)."""
    rng = np.random.default_rng(page_rows + n_cols)
    n_phys = n_valid + 3
    x = rng.normal(size=(n_phys, page_rows, n_cols)).astype(np.float32)
    table = np.full(1 << (n_valid - 1).bit_length(), 10_000, np.int32)
    table[:n_valid] = rng.permutation(n_phys)[:n_valid]
    unit = min(page_rows, tref.TOPK_UNIT_ROWS)
    dup = (0, unit - 1, unit, n_rows - 1)
    src = x[table[0], 0] * 3
    for r in dup:
        x[table[r // page_rows], r % page_rows] = src
    q = src.copy()
    if page_dtype == "f32":
        return ((jnp.asarray(x), None), (torch.from_numpy(x), None), q,
                table, dup)
    code, qmax = _CODES[page_dtype]
    codes, scale = jkv.quantize_page_kv(jnp.asarray(x), qmax, code)
    raw = np.asarray(codes).view(np.uint8 if page_dtype == "fp8"
                                 else np.int8)
    t_codes = torch.from_numpy(raw.copy())
    if page_dtype == "fp8":
        t_codes = t_codes.view(torch.float8_e4m3fn)
    return ((codes, scale), (t_codes, torch.from_numpy(
        np.asarray(scale).copy())), q, table, dup)


@pytest.mark.parametrize("metric", ["dot", "cosine"])
@pytest.mark.parametrize("k", [4, 128])
@pytest.mark.parametrize("shape", POOL_SHAPES,
                         ids=[f"{s[0]}x{s[1]}-{s[2]}" for s in POOL_SHAPES])
def test_block_split_over_units_equals_plain_and_pallas(shape, k, metric):
    """Pools the card path refused before: every block count from one to
    one a unit gives the plain version's bits and the Pallas top-k's
    ids."""
    page_rows, n_cols, page_dtype, n_valid, n_rows = shape
    (jp, js), (tp, ts), q, table_np, dup = _shaped_pool(*shape)
    table = torch.from_numpy(table_np)
    query = torch.from_numpy(q)
    plain = tref.topk_scan_ref(tp, table, n_rows, query, k=k,
                               metric=metric, scales=ts)
    units = tref.topk_units(n_valid, page_rows, tref.topk_tma_path(
        page_rows, n_cols, tp.element_size(), ts is not None))
    for n_blocks in sorted({1, 2, 3, units}):
        got = tref.topk_blocks_emulated(tp, table, n_rows, query, k=k,
                                        metric=metric, scales=ts,
                                        n_blocks=n_blocks)
        assert torch.equal(got, plain), n_blocks
    want = np.asarray(jops.topk_scan(jp, jnp.asarray(table_np), n_rows,
                                     jnp.asarray(q)[None, :], k=k,
                                     metric=metric, scales=js,
                                     interpret=True))
    got = plain.numpy()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=SCORE_RTOL, atol=0)
    if metric == "dot":
        # the planted copies, across units and pages, first by row id
        ids = [float((r // page_rows) * page_rows + r % page_rows)
               for r in sorted(set(dup))]
        assert list(got[1, :len(ids)]) == ids
