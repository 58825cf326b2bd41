"""The port's in-storage scan, top-k and embedding wrappers (plain
versions on the CPU) held against the JAX package's Pallas kernels in
interpret mode, on the same numpy inputs and the same page codes.

Count, min, max, top-k ids and gathers must match bit for bit.  The JAX
scan sums a page's rows with ``jnp.sum``, whose order is not defined, so
column sums are held within 1e-5; the port fixes that order, and its own
pool fold and host fold must agree bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import kv_tier as jkv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

SUM_TOL = 1e-5        # the JAX package's in-page jnp.sum has no fixed order
SCORE_RTOL = 1e-6
N_PHYS, PAGE_ROWS, N_COLS = 12, 8, 16
TABLE = np.array([3, 7, 1, 9, 10, 0, 0, 0], np.int32)   # 5 live, pow2 pad
N_ROWS = 37                                            # last page partial
_CODES = {"int8": (jnp.int8, 127.0), "fp8": (jnp.float8_e4m3fn, 448.0)}


def _pool(page_dtype, seed=0):
    """A pool of pages with integer-valued column 1 (for eq/ne) and
    continuous columns, as (JAX operands, port operands)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_PHYS, PAGE_ROWS, N_COLS)).astype(np.float32)
    x[:, :, 1] = np.round(x[:, :, 1] * 2)
    if page_dtype == "fp32":
        return (jnp.asarray(x), None), (torch.from_numpy(x), None)
    code, qmax = _CODES[page_dtype]
    codes, scale = jkv.quantize_page_kv(jnp.asarray(x), qmax, code)
    raw = np.asarray(codes).view(np.uint8 if page_dtype == "fp8"
                                 else np.int8)
    t_codes = torch.from_numpy(raw.copy())
    if page_dtype == "fp8":
        t_codes = t_codes.view(torch.float8_e4m3fn)
    return ((codes, scale),
            (t_codes, torch.from_numpy(np.asarray(scale).copy())))


def _assert_blocks(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[[0, 2, 3, 4, 5, 6, 7]],
                                  want[[0, 2, 3, 4, 5, 6, 7]])
    np.testing.assert_allclose(got[1], want[1], rtol=SUM_TOL, atol=SUM_TOL)


SCAN_CASES = [("all", 0, 0.0), ("ge", 2, 0.1), ("lt", 5, -0.3),
              ("eq", 1, 0.0), ("ne", 1, 1.0)]


@pytest.mark.parametrize("page_dtype", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("op,col,thresh", SCAN_CASES)
def test_scan_matches_pallas(page_dtype, op, col, thresh):
    (jp, js), (tp, ts) = _pool(page_dtype)
    want = jops.scan_filter_reduce(jp, jnp.asarray(TABLE), N_ROWS, thresh,
                                   scales=js, filter_col=col, filter_op=op)
    got = tops.scan_filter_reduce(tp, torch.from_numpy(TABLE), N_ROWS,
                                  thresh, scales=ts, filter_col=col,
                                  filter_op=op)
    _assert_blocks(got.numpy(), want)
    # the port's own pool fold equals its host fold over the rows, bitwise
    rows = tops.ref.pool_rows(tp, ts, torch.from_numpy(TABLE[:5]).long())
    host = tops.scan_filter_reduce_host(rows.reshape(-1, N_COLS)[:N_ROWS],
                                        thresh, page_rows=PAGE_ROWS,
                                        filter_col=col, filter_op=op)
    assert torch.equal(got, host)


def test_scan_pow2_padded_table_reads_only_valid_pages():
    (jp, _), (tp, _) = _pool("fp32", seed=1)
    # 3 valid pages padded to 8 with an id far outside the pool
    table = np.array([4, 2, 8, 99, 99, 99, 99, 99], np.int32)
    got = tops.scan_filter_reduce(tp, torch.from_numpy(table), 24, 0.0,
                                  filter_op="ge")
    want = jops.scan_filter_reduce(jp, jnp.asarray(table[:3]), 24, 0.0,
                                   filter_op="ge")
    _assert_blocks(got.numpy(), want)


@pytest.mark.parametrize("n_rows", [0, N_ROWS])
def test_scan_empty_result_keeps_sentinels(n_rows):
    (jp, _), (tp, _) = _pool("fp32", seed=2)
    got = tops.scan_filter_reduce(tp, torch.from_numpy(TABLE), n_rows, 1e9,
                                  filter_col=3, filter_op="ge").numpy()
    want = np.asarray(jops.scan_filter_reduce(
        jp, jnp.asarray(TABLE), n_rows, 1e9, filter_col=3, filter_op="ge"))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 0 and (got[2] == np.float32(1e30)).all() and \
        (got[3] == np.float32(-1e30)).all() and not got[1].any()


TOPK_CASES = [("fp32", "dot", 5), ("fp32", "cosine", 5), ("fp32", "dot", 64),
              ("int8", "dot", 7), ("fp8", "cosine", 7)]


@pytest.mark.parametrize("page_dtype,metric,k", TOPK_CASES)
def test_topk_matches_pallas(page_dtype, metric, k):
    (jp, js), (tp, ts) = _pool(page_dtype, seed=3)
    q = np.random.default_rng(4).normal(size=(N_COLS,)).astype(np.float32)
    want = np.asarray(jops.topk_scan(jp, jnp.asarray(TABLE), N_ROWS,
                                     jnp.asarray(q), k=k, metric=metric,
                                     scales=js))
    got = tops.topk_scan(tp, torch.from_numpy(TABLE), N_ROWS,
                         torch.from_numpy(q), k=k, metric=metric,
                         scales=ts).numpy()
    assert got.shape == want.shape == (8, tops.topk_pad(k))
    np.testing.assert_array_equal(got[1], want[1])           # ids
    np.testing.assert_allclose(got[0], want[0], rtol=SCORE_RTOL, atol=0)
    assert not got[2:].any()
    if k > N_ROWS:                          # empty slots are sentinels
        assert (got[1, N_ROWS:k] == 2.0 ** 30).all()
        assert (got[0, N_ROWS:k] == np.float32(-1e30)).all()


def test_topk_duplicate_rows_break_ties_on_row_id():
    x = np.random.default_rng(5).normal(size=(N_PHYS, PAGE_ROWS, N_COLS))
    x = x.astype(np.float32)
    x[9, 2] = x[3, 1]           # logical rows 1, 26 and 29 are identical
    x[9, 5] = x[3, 1]
    q = x[3, 1].copy()
    want = np.asarray(jops.topk_scan(jnp.asarray(x), jnp.asarray(TABLE),
                                     N_ROWS, jnp.asarray(q), k=4))
    got = tops.topk_scan(torch.from_numpy(x), torch.from_numpy(TABLE),
                         N_ROWS, torch.from_numpy(q), k=4).numpy()
    np.testing.assert_array_equal(got[1], want[1])
    assert list(got[1, :3]) == [1.0, 26.0, 29.0]
    assert got[0, 0] == got[0, 1] == got[0, 2]
    # the host fold over the same rows agrees bit for bit
    rows = torch.from_numpy(x[TABLE[:5]].reshape(-1, N_COLS)[:N_ROWS])
    host = tops.topk_scan_host(rows, torch.from_numpy(q),
                               page_rows=PAGE_ROWS, k=4).numpy()
    np.testing.assert_array_equal(got, host)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_embed_gather_matches_pallas(dtype):
    rng = np.random.default_rng(6)
    table = (rng.normal(size=(40, 12)) * 100).astype(dtype)
    idx = rng.integers(0, 40, (3, 5), dtype=np.int32)
    want = np.asarray(jops.embed_gather(jnp.asarray(table), jnp.asarray(idx)))
    got = tops.embed_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.from_numpy(table).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("weighted", [False, True])
def test_embed_agg_matches_pallas(weighted):
    rng = np.random.default_rng(7)
    table = rng.normal(size=(64, 24)).astype(np.float32)
    idx = rng.integers(0, 64, (5, 16), dtype=np.int32)
    w = rng.uniform(0.5, 2.0, (5, 16)).astype(np.float32) if weighted \
        else None
    want = np.asarray(jops.embed_agg(
        jnp.asarray(table), jnp.asarray(idx),
        None if w is None else jnp.asarray(w)))
    got = tops.embed_agg(torch.from_numpy(table), torch.from_numpy(idx),
                         None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("call,err", [
    (lambda t, tb: tops.scan_filter_reduce(t, tb, 8, 0.0, filter_op="gt"),
     ValueError),
    (lambda t, tb: tops.scan_filter_reduce(t, tb, 8, 0.0, filter_col=16),
     ValueError),
    (lambda t, tb: tops.topk_scan(t, tb, 8, torch.zeros(16), k=0),
     ValueError),
    (lambda t, tb: tops.topk_scan(t, tb, 8, torch.zeros(16), k=129),
     ValueError),
    (lambda t, tb: tops.topk_scan(t, tb, 8, torch.zeros(16), k=2,
                                  metric="l2"), ValueError),
    (lambda t, tb: tops.topk_scan(t, tb, 8, torch.zeros(15), k=2),
     ValueError),
    (lambda t, tb: tops.scan_filter_reduce(t.to(torch.int8), tb, 8, 0.0),
     ValueError),                                   # codes without scales
    (lambda t, tb: tops.scan_filter_reduce(t, tb.long(), 8, 0.0),
     TypeError),
    (lambda t, tb: tops.embed_agg(t[0], torch.tensor([[0, 8]])),
     ValueError),                                   # id out of range
    (lambda t, tb: tops.embed_agg(t[0], torch.tensor([[-1, 0]])),
     ValueError),
    (lambda t, tb: tops.embed_gather(t[0], torch.tensor([[0.0, 1.0]])),
     TypeError),                                    # float ids
    (lambda t, tb: tops.embed_gather(t[0], torch.tensor([0, 1])),
     ValueError),                                   # not [B, K]
])
def test_wrappers_reject_bad_arguments(call, err):
    pages = torch.zeros((N_PHYS, PAGE_ROWS, N_COLS))
    with pytest.raises(err):
        call(pages, torch.from_numpy(TABLE))
