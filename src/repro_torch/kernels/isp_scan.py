"""Wrappers of the hand-written in-storage scan and top-k CUDA kernels.

``csrc/isp_scan.cu`` replaces the JAX package's Pallas TPU kernels
``_scan_kernel``/``_scan_q_kernel`` and ``_topk_kernel``/
``_topk_q_kernel`` (``repro/kernels/isp_scan.py:120, :162, :376,
:414``).  Each wrapper checks device, dtype, shape, contiguity and
alignment and raises on what the kernel does not take, allocates the
output and the per-block partials with ``torch.empty``, launches on the
current CUDA stream and raises if the launcher returns a CUDA error.
For tensors on the CPU (and only there) it runs the plain version in
``kernels.ref``.  ``LAUNCHES`` counts wrapper calls that launched their
kernel (one launch a call: the scan's streaming blocks and its ordered
fold run in one grid; the top-k's blocks and merge likewise), one entry
per compiled page format.

``n_rows`` and ``threshold`` are host scalars: nothing here waits for
the card.  Page ids are trusted: the table's first ``n_valid_pages``
entries must name pages of the pool (``ExtentStore`` guarantees it);
the entries past them, e.g. pow2 padding, are never read.
"""
from __future__ import annotations

import ctypes
import functools
import operator

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.ref import (BIG_ID, FILTER_OPS, MAX_TOPK,  # noqa: F401
                                     NEG_INF, POS_INF, REDUCE_ROWS,
                                     TOPK_METRICS, n_valid_pages, topk_pad)

LAUNCHES = {f"{kind}_{code}": 0 for kind in ("scan_filter_reduce",
                                             "topk_scan")
            for code in ("f32", "int8", "fp8")}

_CODE = {torch.float32: "f32", torch.int8: "int8",
         torch.float8_e4m3fn: "fp8"}

#: persistent top-k blocks a streaming multiprocessor (two fit its
#: shared memory at page 128)
TOPK_BLOCKS_PER_SM = 2
#: persistent scan blocks a streaming multiprocessor (a few of the
#: grid's blocks fold, the others stream)
SCAN_BLOCKS_PER_SM = 2

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _bind(name: str):
    return typed(getattr(build.load_library("isp_scan"), name), name)


def typed(fn, name: str):
    """``fn``, the launcher ``name`` of a build of ``csrc/isp_scan.cu``,
    with its ctypes signature set."""
    if name.startswith("scan"):
        # pages, scales, table, ws, flags, out, n_rows, threshold,
        # n_valid, page_rows, n_cols, filter_col, filter_op, then the
        # plan (ref.ScanPlan's fields but smem, in order), epoch,
        # follow_only, smem, stream
        fn.argtypes = [_P] * 6 + [_LL, _F] + [_I] * 24 + [_P]
    else:
        # pages, scales, query, table, list_s, list_i, done, out, n_phys,
        # n_valid, page_rows, n_cols, n_rows, k, kpad, cosine, n_blocks,
        # stream
        fn.argtypes = [_P] * 8 + [_I, _I, _I, _I, _LL, _I, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: the top-k's last-block tickets, one zeroed int32 a (device, stream);
#: the kernel's last block resets its ticket
_TICKETS = {}


def _ticket(device, stream: int):
    key = (device.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _TICKETS[key]


#: the scan's ready flags, one zeroed int32 buffer and the count of
#: calls (the epoch the flags are set to) a (device, stream)
_SCAN_FLAGS = {}
_EPOCH_MAX = 2 ** 31 - 1


def _scan_flags(device, stream: int, need: int):
    """(flags, epoch) for the next scan call on ``stream``: at least
    ``need`` flags, all below the epoch returned."""
    key = (device.index, stream)
    state = _SCAN_FLAGS.get(key)
    if state is None or state[0].numel() < need:
        size = max(need, 4096, 2 * state[0].numel() if state else 0)
        state = _SCAN_FLAGS[key] = [
            torch.zeros(size, dtype=torch.int32, device=device), 0]
    state[1] += 1
    if state[1] == _EPOCH_MAX:
        state[0].zero_()
        state[1] = 1
    return state


def check_topk_pool(pages, scales, query) -> str:
    """The top-k kernel's path for this pool, as ``launch_topk`` in
    ``csrc/isp_scan.cu`` picks it (``ref.topk_tma_path``): ``"tma"``
    (the ring of tensor-map boxes) for rows of a multiple of 16 bytes
    with the pool and query 16-byte aligned and code pages of a multiple
    of 4 rows, else ``"direct"`` (each row thread reads its row); any
    page_rows and row count.  Raises only where no path can read the
    tensors: a pointer not aligned to its element."""
    n_phys, page_rows, n_cols = pages.shape
    for t in (pages, scales, query):
        if t is not None and t.data_ptr() % t.element_size():
            raise ValueError("the top-k kernel reads the pool, scales and "
                             "query aligned to their elements")
    aligned = pages.data_ptr() % 16 == 0 and query.data_ptr() % 16 == 0
    tma = ref.topk_tma_path(page_rows, n_cols, pages.element_size(),
                            scales is not None, aligned)
    return "tma" if tma else "direct"


def _check_pool(pages, page_table, scales):
    if pages.dim() != 3:
        raise ValueError(f"pages must be [n_phys, page_rows, n_cols]; got "
                         f"{tuple(pages.shape)}")
    if pages.dtype not in _CODE:
        raise TypeError(f"pages must be one of {tuple(_CODE)}, got "
                        f"{pages.dtype}")
    n_phys, page_rows, _ = pages.shape
    if (pages.dtype != torch.float32) != (scales is not None):
        raise ValueError("scales go with an int8/fp8 pool, and only there")
    if scales is not None:
        if scales.numel() != n_phys * page_rows or \
                scales.shape[:2] != (n_phys, page_rows):
            raise ValueError(f"scales must be [{n_phys}, {page_rows}]; got "
                             f"{tuple(scales.shape)}")
        if scales.dtype != torch.float32:
            raise TypeError("scales must be float32")
    if page_table.dim() != 1 or page_table.numel() < 1:
        raise ValueError(f"page_table must be a non-empty [pps] vector; "
                         f"got {tuple(page_table.shape)}")
    if page_table.dtype != torch.int32:
        raise TypeError("page_table must be int32")


def _check_cuda(*tensors):
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}; one is on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous inputs only")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def scan_filter_reduce(pages, page_table, n_rows, threshold=0.0, *,
                       scales=None, filter_col: int = 0,
                       filter_op: str = "all"):
    """Filtered aggregate over an extent's pages of a pool.

    pages: [n_phys, page_rows, n_cols] f32, or int8/fp8-e4m3 codes with
    ``scales`` [n_phys, page_rows] f32 per-row scales; page_table: [pps]
    int32 physical ids (pow2 padding allowed); n_rows: valid rows and
    threshold: the filter operand (rounded to f32), both host scalars.
    Returns [8, n_cols] f32: count (broadcast), per-column sum, min, max
    over the rows passing ``filter_op`` on ``filter_col``; rows 4-7 zero.
    Bit-identical to ``ref.scan_filter_reduce_ref``.  On the card, one
    launch (``ref.scan_plan`` splits the work; up to about 16,000
    columns).
    """
    if filter_op not in FILTER_OPS:
        raise ValueError(f"filter_op must be one of {FILTER_OPS}, "
                         f"got {filter_op!r}")
    _check_pool(pages, page_table, scales)
    n_phys, page_rows, n_cols = pages.shape
    if not 0 <= filter_col < n_cols:
        raise ValueError(f"filter_col {filter_col} out of range "
                         f"[0, {n_cols})")
    n_rows = operator.index(n_rows)
    threshold = float(threshold)
    if pages.device.type == "cpu":
        return ref.scan_filter_reduce_ref(
            pages, page_table, n_rows, threshold, scales=scales,
            filter_col=filter_col, filter_op=filter_op)
    call = _ScanCall(pages, page_table, n_rows, threshold, scales,
                     filter_col, filter_op)
    call.launch()
    LAUNCHES[call.name] += 1
    return call.out


def scan_plan_of(pages, page_table, n_rows, scales=None) -> ref.ScanPlan:
    """The work split (``ref.scan_plan``) :func:`scan_filter_reduce`
    takes for these operands on the card: its path (TMA ring when
    ``plan.tma``), chunks, fold blocks and passes, producer blocks."""
    n_phys, page_rows, n_cols = pages.shape
    aligned = all(t is None or t.data_ptr() % 16 == 0
                  for t in (pages, scales))
    return ref.scan_plan(
        n_valid_pages(n_rows, page_rows, page_table.shape[0]), page_rows,
        n_cols, pages.element_size(), scales is not None,
        SCAN_BLOCKS_PER_SM * _sm_count(pages.device.index or 0), aligned)


class _ScanCall:
    """One scan on the card: its plan (``ref.scan_plan``), workspace and
    output, launched by :meth:`launch`."""

    def __init__(self, pages, page_table, n_rows, threshold, scales,
                 filter_col, filter_op):
        _check_cuda(pages, page_table, scales)
        for t in (pages, scales):
            if t is not None and t.data_ptr() % t.element_size():
                raise ValueError("the scan kernel reads the pool and scales "
                                 "aligned to their elements")
        n_phys, page_rows, n_cols = pages.shape
        dev = pages.device
        n_valid = n_valid_pages(n_rows, page_rows, page_table.shape[0])
        p = self.plan = scan_plan_of(pages, page_table, n_rows, scales)
        # the fold values [n_cols + 1, pad_pages], then the producer
        # blocks' min/max [n_prod, 2, n_cols]
        self.ws = torch.empty((n_cols + 1) * p.pad_pages +
                              p.n_prod * 2 * n_cols, device=dev)
        self.out = torch.empty((REDUCE_ROWS, n_cols), device=dev)
        self.name = f"scan_filter_reduce_{_CODE[pages.dtype]}"
        self.operands = (pages, scales, page_table, n_rows, threshold,
                         n_valid, page_rows, n_cols, filter_col,
                         FILTER_OPS.index(filter_op))

    def launch(self, follow_only: bool = False):
        (pages, scales, page_table, n_rows, threshold, n_valid, page_rows,
         n_cols, filter_col, op) = self.operands
        p = self.plan
        stream = torch.cuda.current_stream(pages.device).cuda_stream
        flags, epoch = _scan_flags(pages.device, stream,
                                   p.n_chunks + p.n_prod)
        # fp8 codes: the bytes are handed over as-is and read as
        # __nv_fp8_e4m3
        err = _bind(self.name)(
            pages.data_ptr(), _ptr(scales), page_table.data_ptr(),
            self.ws.data_ptr(), flags.data_ptr(), self.out.data_ptr(),
            n_rows, threshold, n_valid, page_rows, n_cols, filter_col, op,
            *(int(v) for v in p[:-1]), epoch, int(follow_only), p.smem,
            stream)
        _raise_on(err, self.name)


def scan_chain_runner(pages, page_table, n_rows, threshold=0.0, *,
                      scales=None, filter_col: int = 0,
                      filter_op: str = "all"):
    """A callable that launches the scan kernel's ordered fold alone (its
    fold blocks, over the fold values one full scan of these operands
    left; no flags waited for, min/max not folded): the time of the
    page-order chain, the scan's second bound.  Card only; the full scan it runs
    first counts in ``LAUNCHES``, the fold-alone launches do not."""
    if pages.device.type != "cuda":
        raise ValueError("scan_chain_runner times the kernel on the card")
    call = _ScanCall(pages, page_table, operator.index(n_rows),
                     float(threshold), scales, filter_col, filter_op)
    call.launch()
    LAUNCHES[call.name] += 1
    return functools.partial(call.launch, follow_only=True)


def topk_scan(pages, page_table, n_rows, query, *, k: int,
              metric: str = "dot", scales=None):
    """Query-scored top-k over an extent's pages of a pool.

    The pool operands are those of :func:`scan_filter_reduce`; query:
    [n_cols] (or [1, n_cols]) f32.  Each valid row is scored by the
    column add chain of its products with the query (``cosine``: over
    max(sqrt(chain(x*x)), 1e-6)); the k best by (score descending, row
    id ascending) are kept, k in [1, 128].  Returns [8, topk_pad(k)]
    f32: scores on row 0, row ids as f32 on row 1, empty slots
    (-1e30, 2^30).  Bit-identical to ``ref.topk_scan_ref``.  Any
    page_rows and n_cols; :func:`check_topk_pool` names the kernel's path.
    """
    if metric not in TOPK_METRICS:
        raise ValueError(f"metric must be one of {TOPK_METRICS}, "
                         f"got {metric!r}")
    if not 1 <= k <= MAX_TOPK:
        raise ValueError(f"k must be in [1, {MAX_TOPK}], got {k}")
    _check_pool(pages, page_table, scales)
    n_phys, page_rows, n_cols = pages.shape
    if query.numel() != n_cols or query.dim() > 2:
        raise ValueError(f"query must be [{n_cols}] or [1, {n_cols}], got "
                         f"{tuple(query.shape)}")
    if query.dtype != torch.float32:
        raise TypeError("query must be float32")
    n_rows = operator.index(n_rows)
    if pages.device.type == "cpu":
        return ref.topk_scan_ref(pages, page_table, n_rows, query, k=k,
                                 metric=metric, scales=scales)
    query = query.reshape(n_cols)
    _check_cuda(pages, page_table, scales, query)
    path = check_topk_pool(pages, scales, query)
    n_valid = n_valid_pages(n_rows, page_rows, page_table.shape[0])
    dev = pages.device
    n_blocks = min(ref.topk_units(n_valid, page_rows, path == "tma"),
                   TOPK_BLOCKS_PER_SM * _sm_count(dev.index or 0))
    # the blocks' sorted lists: scores, then ids
    lists = torch.empty((2, n_blocks, k), dtype=torch.int32, device=dev)
    kpad = topk_pad(k)
    out = torch.empty((REDUCE_ROWS, kpad), device=dev)
    name = f"topk_scan_{_CODE[pages.dtype]}"
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _bind(name)(pages.data_ptr(), _ptr(scales), query.data_ptr(),
                      page_table.data_ptr(), lists[0].data_ptr(),
                      lists[1].data_ptr(), _ticket(dev, stream).data_ptr(),
                      out.data_ptr(), n_phys, n_valid, page_rows, n_cols,
                      n_rows, k, kpad, int(metric == "cosine"), n_blocks,
                      stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out
