"""Offload planner — Host vs D-VirtFW per analytics request.

The paper's Fig 11 verdict is an *average*: in-storage processing wins
on I/O-intensive workloads (pattern, rocksdb-read) and loses when the
reduction ratio is poor or the job is compute-bound (the 2.2 GHz
frontend pays ``ssd_slowdown``).  A production pool therefore decides
*per request*, from the same calibrated cost constants the Fig-3/11
models use (``core.isp_perf.IspCosts``):

  Host      = host-IO per-page + host-bandwidth transfer of the whole
              extent + host-syscall system path + host-speed compute
  D-VirtFW  = internal flash IO/bandwidth + function-call syscalls +
              SSD-speed compute + Ether-oN frames for the job and the
              *reduced* aggregate only

Jobs that plan onto the device are **batched per node** (one JOB frame,
one container run, one RESULTS frame per node) and run across the
``StoragePool`` alongside serving: when a :class:`~repro_torch.runtime.
scheduler.PoolRouter` is attached, the planner shares its admission
surface — a serving node with no window headroom left falls back to the
host path instead of stealing the node (shared nodes, one admission
truth).

The port of ``repro.runtime.offload``.  Its host leg folds the fetched
extent with the port's ``*_host`` folds on the host CPU, bit-identical
to the in-storage kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.container import from_jsonable
from repro_torch.core.ether_on import MTU, EtherONError
from repro_torch.core.extent_store import AnalyticsJob, project
from repro_torch.core.isp_perf import IspCosts
from repro_torch.kernels import ops
from repro_torch.kernels.isp_scan import REDUCE_ROWS, topk_pad


@dataclasses.dataclass
class OffloadEstimate:
    """Modeled latencies (seconds) for one job, both placements."""
    node_ip: str
    bytes_scanned: int
    result_bytes: int
    host_s: float
    dvirtfw_s: float

    @property
    def choice(self) -> str:
        return "device" if self.dvirtfw_s < self.host_s else "host"

    @property
    def modeled_speedup(self) -> float:
        return self.host_s / self.dvirtfw_s


class OffloadPlanner:
    """Decide, batch and execute analytics jobs over a StoragePool.

    ``scan_gbs`` is the host-speed effective scan rate of the reduce
    kernel (bytes through the predicate+fold per second) — the one
    constant not in ``IspCosts`` because it belongs to the operator,
    not the platform.  ``io_bytes`` is the per-IO granularity the cost
    model charges ``host_io_us``/``flash_io_us`` against.
    """

    def __init__(self, pool, costs: IspCosts = IspCosts(), *,
                 router=None, scan_gbs: float = 8.0,
                 io_bytes: int = 128 * 1024):
        self.pool = pool
        self.router = router
        self.costs = costs
        self.scan_gbs = scan_gbs
        self.io_bytes = io_bytes

    # -- cost model ------------------------------------------------------------

    def estimate(self, job: AnalyticsJob) -> OffloadEstimate:
        ip = self.pool.locate_extent(job.extent)
        if ip is None:
            raise KeyError(f"extent {job.extent!r} not found on any "
                           f"alive node")
        store = self.pool.nodes[ip].extents
        ext = store.extents[job.extent]
        nbytes = ext.nbytes
        ios = max(1, -(-nbytes // self.io_bytes))
        # system path: submit/complete syscalls per IO plus the handful
        # of opens/walks around the scan
        n_sys = 8 + 2 * ios
        # per-request operator intensity: the job's hint wins over the
        # planner default, so one compute-bound request among
        # I/O-intensive ones flips to the host on its own
        compute_s = nbytes / 1e9 / (job.scan_gbs or self.scan_gbs)
        c = self.costs

        host_s = (ios * c.host_io_us * 1e-6 +
                  nbytes / 1e9 / c.host_bw_gbs +
                  n_sys * c.host_syscall_us * 1e-6 +
                  2 * c.path_walk_us * 1e-6 +
                  compute_s)

        # topk returns its own tile-padded block; everything else
        # returns the store-width aggregate
        out_cols = topk_pad(job.k) if job.reduce == "topk" else store.n_cols
        result_bytes = REDUCE_ROWS * out_cols * 4
        frames = 1 + max(1, -(-result_bytes // MTU))     # job + result
        dvirtfw_s = (ios * c.flash_io_us * 1e-6 +
                     nbytes / 1e9 / c.flash_bw_gbs +
                     n_sys * c.virtfw_call_us * 1e-6 +
                     2 * c.virtfw_walk_us * 1e-6 +
                     compute_s * c.ssd_slowdown +
                     frames * c.etheron_pkt_us * 1e-6)
        return OffloadEstimate(ip, nbytes, result_bytes, host_s, dvirtfw_s)

    def plan(self, jobs: List[AnalyticsJob]) -> List[OffloadEstimate]:
        return [self.estimate(j) for j in jobs]

    # -- shared admission with the serving router --------------------------------

    def _node_admits(self, ip: str) -> bool:
        """A serving node with no free window pages is off limits to
        analytics — the router's admission accounting is the one truth
        for shared nodes."""
        if self.router is None or self.pool._server is None:
            return True
        serve_ips = self.pool.serving_ips()
        if ip not in serve_ips:
            return True
        shard = serve_ips.index(ip)
        headroom = self.router.node_headroom()
        return headroom.get(shard, 0) > 0

    # -- execution --------------------------------------------------------------

    def execute(self, jobs: List[AnalyticsJob],
                force: Optional[str] = None) -> List[dict]:
        """Run every job where the cost model says it belongs
        (``force`` pins all jobs to ``"host"``/``"device"``).  Device
        jobs are batched per node into one JOB frame each; host jobs
        fetch the extent over the tunnel and fold with the bit-identical
        reference path.  Returns one record per job, input order."""
        ests = self.plan(jobs)
        records: List[Optional[dict]] = [None] * len(jobs)
        batches: Dict[str, List[int]] = {}
        for i, (job, est) in enumerate(zip(jobs, ests)):
            where = force or est.choice
            if force is None and where == "device":
                # an explicit force="device" is a pin, never rerouted
                if self.pool.nodes[est.node_ip].suspect:
                    where = "host-suspect"     # straggler: no new jobs
                elif not self._node_admits(est.node_ip):
                    where = "host-admission"   # serving owns the node now
            if where == "device":
                batches.setdefault(est.node_ip, []).append(i)
            else:
                try:
                    records[i] = self._run_host(job, est, where)
                except EtherONError:
                    self.pool.mark_unreachable(est.node_ip)
                    records[i] = self._retry_elsewhere(job, est)
        for ip, idxs in batches.items():
            payload = [jobs[i].to_dict() for i in idxs]
            try:
                out = from_jsonable(self.pool.driver.submit_jobs(
                    ip, payload))
            except EtherONError:
                # the node vanished between placement and submission —
                # each job retries on a healthy replica or the host
                self.pool.mark_unreachable(ip)
                for i in idxs:
                    records[i] = self._retry_elsewhere(jobs[i], ests[i])
                continue
            for i, block in zip(idxs, out):
                records[i] = {"job": jobs[i], "where": "device",
                              "est": ests[i], "block": block,
                              "result": project(block, jobs[i])}
        return records

    def _retry_elsewhere(self, job: AnalyticsJob,
                         est: OffloadEstimate) -> dict:
        """Degradation ladder for a job whose node became unreachable:
        resubmit on the best surviving replica; if its RESULTS never
        arrive either, fetch the extent and fold on the host
        (bit-identical to the in-storage reduce); only when every
        replica's node is gone does the job fail."""
        while True:
            ip = self.pool.locate_extent(job.extent)   # prefers healthy
            if ip is None:
                raise EtherONError(
                    f"extent {job.extent!r} unreachable: every replica's "
                    f"node is dead")
            est2 = dataclasses.replace(est, node_ip=ip)
            try:
                out = from_jsonable(self.pool.driver.submit_jobs(
                    ip, [job.to_dict()]))
                return {"job": job, "where": "device-retry", "est": est2,
                        "block": out[0], "result": project(out[0], job)}
            except EtherONError:
                pass
            try:
                return self._run_host(job, est2, "host-fallback")
            except EtherONError:
                self.pool.mark_unreachable(ip)

    def _run_host(self, job: AnalyticsJob, est: OffloadEstimate,
                  where: str) -> dict:
        store = self.pool.nodes[est.node_ip].extents
        data = self.pool.driver.fetch_extent(est.node_ip, job.extent)
        # fold at store width (narrow extents are zero-padded on device
        # pages) so the block matches the in-storage result bit-for-bit
        if data.shape[1] < store.n_cols:
            data = np.pad(data, ((0, 0), (0, store.n_cols - data.shape[1])))
        data = torch.from_numpy(data)
        if job.reduce == "topk":
            block = ops.topk_scan_host(
                data, torch.from_numpy(job.padded_query(store.n_cols)),
                page_rows=store.page_rows, k=job.k, metric=job.metric)
        else:
            block = ops.scan_filter_reduce_host(
                data, job.threshold, page_rows=store.page_rows,
                filter_col=job.filter_col, filter_op=job.filter_op)
        block = block.numpy()
        return {"job": job, "where": where, "est": est, "block": block,
                "result": project(block, job)}
