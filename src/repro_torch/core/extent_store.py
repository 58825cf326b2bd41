"""ExtentStore — device-resident analytics data, in stacked pages.

The port of ``repro.core.extent_store``: one pool of stacked pages
``[n_pages, page_rows, n_cols]`` on a torch device holds every extent's
rows, an *extent* is a named run of physical pages plus a row count,
and the in-storage scan/top-k kernels (``kernels.isp_scan``) read the
pool directly through a per-extent page table.  Pages are updated in
place (``index_copy_``); allocation order, page ids and byte counts are
the JAX package's.

An :class:`AnalyticsJob` is a declarative scan -> filter -> reduce (or
top-k) program that serializes to JSON, so it rides Ether-oN job frames
and λFS rootfs params; the registered ``isp-analytics`` image is its
interpreter and returns numpy aggregates.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.container import (ContainerError, ImageManifest,
                                        make_blob, register_app)
from repro_torch.core.kv_tier import PAGE_DTYPES, quantize_page_kv
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.isp_scan import (BIG_ID, FILTER_OPS, MAX_TOPK,
                                          REDUCE_ROWS, TOPK_METRICS, topk_pad)

#: the generic analytics image every DockerSSD runs (entry = the program
#: interpreter below)
ANALYTICS_IMAGE = "isp-analytics"

#: host-side projections of the kernel's aggregate block ("topk" runs
#: the scored-scan reducer instead of scan/filter/reduce)
REDUCE_KINDS = ("count", "sum", "min", "max", "avg", "table", "topk")

#: page_dtype -> (torch code dtype, qmax, wire name of the code dtype)
_CODES = {"fp32": (torch.float32, 0.0, "float32"),
          "int8": (torch.int8, 127.0, "int8"),
          "fp8": (torch.float8_e4m3fn, 448.0, "float8_e4m3fn")}


class ExtentStoreError(Exception):
    pass


@dataclasses.dataclass
class Extent:
    name: str
    page_ids: List[int]
    n_rows: int
    n_cols: int                     # logical columns (<= store n_cols)
    # stored bytes per row (codes + per-row scale for quantized stores)
    row_bytes: Optional[int] = None

    @property
    def nbytes(self) -> int:
        """Stored bytes the host baseline must move to read this —
        dtype-aware, so the OffloadPlanner prices quantized extent
        reads at their real transfer size."""
        if self.row_bytes is not None:
            return self.n_rows * self.row_bytes
        return self.n_rows * self.n_cols * 4


class ExtentStore:
    """One DockerSSD's flash-resident analytics pages.

    ``pages``: [n_pages, page_rows, n_cols] on ``device`` (default
    ``cuda``), float32 or int8/fp8 codes with ``scales`` [n_pages,
    page_rows] f32 per-row scales.  Extents are page-granular
    allocations out of a free list; the kernels address them through
    per-extent page tables, so extents need not be contiguous.
    """

    def __init__(self, *, n_pages: int = 64, page_rows: int = 128,
                 n_cols: int = 128, page_dtype: str = "fp32",
                 device="cuda"):
        if page_dtype not in PAGE_DTYPES:
            raise ValueError(f"page_dtype must be one of {PAGE_DTYPES}, "
                             f"got {page_dtype!r}")
        self.device = resolve_device(device)
        self.n_pages = n_pages
        self.page_rows = page_rows
        self.n_cols = n_cols
        self.page_dtype = page_dtype
        self.quantized = page_dtype in ("int8", "fp8")
        self.code_dtype, self.qmax, self.code_name = _CODES[page_dtype]
        self.pages = torch.zeros((n_pages, page_rows, n_cols),
                                 dtype=self.code_dtype, device=self.device)
        # per-row scales of a quantized pool (1.0 keeps untouched pages
        # dequantizing to zero); None for full precision
        self.scales = (torch.ones((n_pages, page_rows), device=self.device)
                       if self.quantized else None)
        self.extents: Dict[str, Extent] = {}
        self._free: List[int] = list(range(n_pages))

    # -- capacity ------------------------------------------------------------

    @property
    def row_nbytes(self) -> int:
        """Stored bytes per row: codes (+ the row's f32 scale when
        quantized)."""
        per = self.n_cols * self.pages.element_size()
        return per + (4 if self.quantized else 0)

    @property
    def page_nbytes(self) -> int:
        return self.page_rows * self.row_nbytes

    def free_pages(self) -> int:
        return len(self._free)

    # -- extent life cycle ----------------------------------------------------

    def put(self, name: str, arr) -> Extent:
        """Ingest host data as a new extent (pad rows to page granularity,
        pad columns to the store width); a quantized store quantizes per
        row on the device and writes codes and scales in place."""
        arr = np.asarray(arr, np.float32)
        if arr.ndim != 2:
            raise ExtentStoreError(f"extent data must be 2-D [rows, cols], "
                                   f"got shape {arr.shape}")
        rows, cols = arr.shape
        if cols > self.n_cols:
            raise ExtentStoreError(f"extent has {cols} cols; store width "
                                   f"is {self.n_cols}")
        if name in self.extents:
            raise ExtentStoreError(f"extent {name!r} already exists")
        need = -(-max(rows, 1) // self.page_rows)
        if need > len(self._free):
            raise ExtentStoreError(
                f"ENOSPC: extent {name!r} needs {need} pages, "
                f"{len(self._free)} free")
        ids = [self._free.pop(0) for _ in range(need)]
        blocks = torch.zeros((need * self.page_rows, self.n_cols),
                             device=self.device)
        if not arr.flags.writeable:     # e.g. frombuffer over λFS bytes
            arr = arr.copy()
        blocks[:rows, :cols] = torch.from_numpy(arr).to(self.device)
        blocks = blocks.reshape(need, self.page_rows, self.n_cols)
        idx = torch.tensor(ids, dtype=torch.long, device=self.device)
        if self.quantized:
            codes, scale = quantize_page_kv(blocks, self.qmax,
                                            self.code_dtype)
            # fp8 is written as bytes: not every indexing kernel takes it
            self.pages.view(torch.uint8).index_copy_(
                0, idx, codes.view(torch.uint8))
            self.scales.index_copy_(0, idx, scale)
        else:
            self.pages.index_copy_(0, idx, blocks)
        ext = Extent(name, ids, rows, cols, row_bytes=self.row_nbytes)
        self.extents[name] = ext
        return ext

    def get(self, name: str) -> np.ndarray:
        """Read a whole extent back to the host as f32 numpy (the
        baseline's full transfer; the ISP path never calls this).
        Quantized extents dequantize with the kernel's elementwise f32
        multiply, so a page-sequential fold over this array is
        bit-identical to the in-storage path."""
        ext = self._extent(name)
        x = ops.ref.pool_rows(self.pages, self.scales,
                              self._ids(ext.page_ids))
        flat = x.reshape(-1, self.n_cols)[:ext.n_rows, :ext.n_cols]
        return flat.cpu().numpy()

    def raw_extent(self, name: str):
        """The extent as stored: ``(codes [n_rows, n_cols], scales
        [n_rows] | None)`` as numpy — what crosses the wire on a remote
        read.  fp8 codes come back as their bytes (``uint8``; numpy has
        no fp8), named ``float8_e4m3fn`` on the wire
        (``self.code_name``)."""
        ext = self._extent(name)
        idx = self._ids(ext.page_ids)
        pages = self.pages
        if pages.dtype == torch.float8_e4m3fn:
            pages = pages.view(torch.uint8)
        codes = pages[idx].reshape(-1, self.n_cols)
        codes = codes[:ext.n_rows, :ext.n_cols].cpu().numpy()
        if not self.quantized:
            return codes, None
        scales = self.scales[idx].reshape(-1)[:ext.n_rows].cpu().numpy()
        return codes, scales

    def drop(self, name: str):
        ext = self.extents.pop(name, None)
        if ext is not None:
            self._free.extend(ext.page_ids)

    def page_table(self, name: str) -> torch.Tensor:
        """The extent's page table: [n_pages_of_extent] int32 on the
        store's device."""
        return torch.tensor(self._extent(name).page_ids, dtype=torch.int32,
                            device=self.device)

    def _ids(self, page_ids: List[int]) -> torch.Tensor:
        return torch.tensor(page_ids, dtype=torch.long, device=self.device)

    def _extent(self, name: str) -> Extent:
        if name not in self.extents:
            raise ExtentStoreError(f"no extent {name!r}")
        return self.extents[name]


# ---------------------------------------------------------------------------
# the analytics program (what a MiniDocker app is)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AnalyticsJob:
    """A declarative scan -> filter -> reduce program over one extent.

    Serializes to JSON, so the same object rides the docker-cli front
    door (``start?job=...``), Ether-oN job frames, and λFS rootfs
    params.  ``reduce`` picks the host-visible projection of the
    kernel's aggregate block; ``table`` returns the full block (what
    the correctness contract compares bit-for-bit)."""
    extent: str
    filter_col: int = 0
    filter_op: str = "all"          # one of FILTER_OPS
    threshold: float = 0.0
    reduce: str = "table"           # one of REDUCE_KINDS
    reduce_col: int = 0
    job_id: int = 0
    # operator intensity hint: effective GB/s the operator scans at on
    # the host (0 = the planner's default)
    scan_gbs: float = 0.0
    # retrieval (reduce="topk"): the query vector (zero-padded to the
    # store width at execution), result count, and scoring metric
    query: Optional[List[float]] = None
    k: int = 0
    metric: str = "dot"             # one of TOPK_METRICS

    def validate(self):
        if self.filter_op not in FILTER_OPS:
            raise ContainerError(f"bad filter_op {self.filter_op!r}; "
                                 f"expected one of {FILTER_OPS}")
        if self.reduce not in REDUCE_KINDS:
            raise ContainerError(f"bad reduce {self.reduce!r}; "
                                 f"expected one of {REDUCE_KINDS}")
        if self.reduce == "topk":
            if not self.query:
                raise ContainerError("topk job needs a query vector")
            if not 1 <= self.k <= MAX_TOPK:
                raise ContainerError(f"topk k must be in [1, {MAX_TOPK}], "
                                     f"got {self.k}")
            if self.metric not in TOPK_METRICS:
                raise ContainerError(f"bad metric {self.metric!r}; "
                                     f"expected one of {TOPK_METRICS}")
        elif self.query is not None:
            raise ContainerError(f"query only applies to reduce='topk', "
                                 f"not {self.reduce!r}")
        return self

    def padded_query(self, n_cols: int) -> np.ndarray:
        """The query zero-padded to the executing store's width — the
        same padding ``ExtentStore.put`` applied to narrow extents."""
        qv = np.asarray(self.query, np.float32)
        if qv.ndim != 1 or qv.shape[0] > n_cols:
            raise ContainerError(f"query must be 1-D with <= {n_cols} "
                                 f"entries, got shape {qv.shape}")
        q = np.zeros((n_cols,), np.float32)
        q[:qv.shape[0]] = qv
        return q

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "AnalyticsJob":
        return AnalyticsJob(**d).validate()


def project(block: np.ndarray, job: AnalyticsJob):
    """Host-side projection of the kernel's [8, n_cols] aggregate."""
    if job.reduce == "table":
        return block
    if job.reduce == "topk":
        # [[row_id, score], ...] best-first; (NEG_INF, BIG_ID) empty
        # slots (k > n_rows) are dropped
        scores, ids = block[0], block[1]
        return [[int(i), float(s)]
                for i, s in zip(ids[:job.k], scores[:job.k]) if i < BIG_ID]
    if job.reduce == "count":
        return float(block[0, 0])
    col = job.reduce_col
    if job.reduce == "sum":
        return float(block[1, col])
    if job.reduce == "min":
        return float(block[2, col])
    if job.reduce == "max":
        return float(block[3, col])
    n = block[0, 0]
    return float(block[1, col] / n) if n else float("nan")   # avg


def analytics_blob() -> bytes:
    """The docker blob every node pulls: the generic analytics image
    (the same bytes as the JAX package's)."""
    return make_blob(
        ImageManifest(ANALYTICS_IMAGE, ANALYTICS_IMAGE,
                      ["kernel-layer", "runtime-layer"],
                      config={"kernel": "scan_filter_reduce"}),
        {"kernel-layer": b"pallas scan/filter/reduce",
         "runtime-layer": b"job interpreter"})


@register_app(ANALYTICS_IMAGE)
def isp_analytics(ctx, jobs=None, job_pages=None):
    """The containerized analytics interpreter.

    Parameters arrive the D-VirtFW way: packaged in the container's
    rootfs (λFS ``job.json``, read through function-call syscalls) with
    the raw call args staged in the MPU-checked ISP memory pool.  Each
    job runs one scan or top-k kernel over the node's extent pages and
    returns the reduced aggregate as numpy — the only bytes that travel
    back to the host.
    """
    if jobs is None:
        # rootfs-packaged params: /containers/<cid>/rootfs/job.json
        fd = ctx.syscall("openat", f"/containers/{ctx.c.cid}/rootfs/job.json")
        raw = ctx.syscall("read", fd)
        ctx.syscall("close", fd)
        jobs = json.loads(raw)
    jobs = [j if isinstance(j, AnalyticsJob) else AnalyticsJob.from_dict(j)
            for j in jobs]
    if job_pages is not None:
        # call args staged in the ISP pool must round-trip (compared
        # canonicalized: clients may send sparse dicts)
        staged = [AnalyticsJob.from_dict(d).to_dict()
                  for d in json.loads(ctx.fw.read_job(job_pages))]
        if staged != [j.to_dict() for j in jobs]:
            raise ContainerError("ISP-pool job buffer does not match "
                                 "rootfs params")
    store = ctx.extents
    if store is None:
        raise ContainerError("node has no ExtentStore attached")
    results = []
    for job in jobs:
        if job.extent not in store.extents:
            raise ContainerError(f"no extent {job.extent!r} on this node")
        # cgroup accounting: one resident page + the aggregate
        out_cols = topk_pad(job.k) if job.reduce == "topk" else store.n_cols
        work = store.page_nbytes + REDUCE_ROWS * out_cols * 4
        ctx.alloc(work)
        try:
            n_rows = store.extents[job.extent].n_rows
            if job.reduce == "topk":
                query = torch.from_numpy(job.padded_query(store.n_cols))
                block = ops.topk_scan(
                    store.pages, store.page_table(job.extent), n_rows,
                    query.to(store.device), k=job.k, metric=job.metric,
                    scales=store.scales)
            else:
                block = ops.scan_filter_reduce(
                    store.pages, store.page_table(job.extent), n_rows,
                    job.threshold, scales=store.scales,
                    filter_col=job.filter_col, filter_op=job.filter_op)
            results.append(block.cpu().numpy())
        finally:
            ctx.free(work)
        ctx.log(f"job {job.job_id}: scanned {job.extent} "
                f"({n_rows} rows) filter={job.filter_op} -> {job.reduce}")
    return results
