"""ISP data-processing performance model — Figures 3 and 11, Table 2.

The port of ``repro.core.isp_perf`` (pure Python; numpy for the
geometric means).  Its constants come from the port's own
``core/virtual_fw``; ``IspCosts`` is also what the
:class:`~repro_torch.runtime.offload.OffloadPlanner` prices a job with.
The constants model the paper's prototype (host, SSD frontend, flash,
Ether-oN), not the card the port runs on.

Implements ALL SIX data-processing models of the paper over the 13
workloads of Table 2:

  * ``Host``     — baseline non-ISP system.
  * ``P.ISP-R``  — programmable ISP, RPC interface (Willow-style [3]).
  * ``P.ISP-V``  — programmable ISP, NVMe vendor-specific commands
                   (Biscuit-style [4]); no RPC/network responses.
  * ``D-Naive``  — ISP-container on a separate processor complex running
                   full Linux (SDC'18-style [30]): inter-complex copies.
  * ``D-FullOS`` — container + firmware on one complex, full Linux.
  * ``D-VirtFW`` — DockerSSD: Virtual-FW function-call syscalls, λFS
                   (no LBA-set), rootfs-packaged params (no Kernel-ctx).

Latency decomposes into the paper's six components: Network,
Kernel-ctx, LBA-set, Storage, System, Compute.  Workload characteristics
are the exact Table 2 constants.  Cost constants are calibrated
(benchmarks/calibrate.py) to the paper's aggregate claims:
Fig 3 (Storage ~38% of Host; P.ISP ~1.4x Host e2e; Communicate ~43% of
P.ISP) and Fig 11 (D-VirtFW beats P.ISP-R/V 1.6x, D-Naive 1.8x,
D-FullOS 1.6x, Host 1.3x; P.ISP-V 13.7% under P.ISP-R; D-FullOS +9.3%
over P.ISP-V; D-Naive +12.8% over D-FullOS; P.ISP beats Host only on
rocksdb-read / nginx-filedown).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.virtual_fw import (CONTEXT_SWITCH_US,
                                         EMBEDDED_SYSCALL_US, FUNC_CALL_US,
                                         HOST_SYSCALL_US)


@dataclasses.dataclass(frozen=True)
class Workload:
    program: str
    name: str
    io_size_gb: float
    io_count: float
    syscalls: float
    path_walks: float
    files_opened: float
    tcp_packets: float
    exec_time_s: float


# Table 2, verbatim.  (nginx-web0's TCP count is printed as "543M" in the
# paper table — inconsistent with its 9 s runtime; we read it as 543K,
# matching web1/filedown's magnitude, and note the discrepancy.)
WORKLOADS: List[Workload] = [
    Workload("embed", "rm1", 1.3, 317e3, 1.3e6, 9e3, 260, 0, 8),
    Workload("embed", "rm2", 5.8, 1.4e6, 1.7e6, 9e3, 320, 0, 24),
    Workload("mariadb", "tpch4", 17.1, 1.1e6, 1.1e6, 37e3, 250, 160, 25),
    Workload("mariadb", "tpch11", 6.2, 400e3, 361e3, 38e3, 260, 190, 8),
    Workload("rocksdb", "read", 4.1, 431e3, 1.1e6, 9e3, 1.2e3, 0, 14),
    Workload("rocksdb", "write", 18.5, 24e3, 285e3, 9e3, 3.6e3, 0, 24),
    Workload("pattern", "find", 2.4, 381e3, 1.8e6, 359e3, 352e3, 0, 11),
    Workload("pattern", "line", 1.7, 262e3, 1.7e6, 476e3, 235e3, 0, 11),
    Workload("pattern", "word", 2.1, 340e3, 2.2e6, 618e3, 307e3, 0, 10),
    Workload("nginx", "web0", 7.5, 126e3, 665e3, 126e3, 4.4e3, 543e3, 9),
    Workload("nginx", "web1", 0.9, 50e3, 344e3, 109e3, 2e3, 154e3, 3),
    Workload("nginx", "filedown", 13.5, 109e3, 30e3, 1e3, 40, 155e3, 6),
    Workload("vsftpd", "fileup", 12.1, 93e3, 5.4e6, 127e3, 115e3, 1.2e6, 2),
]

MODELS = ["Host", "P.ISP-R", "P.ISP-V", "D-Naive", "D-FullOS", "D-VirtFW"]
COMPONENTS = ["Network", "Kernel-ctx", "LBA-set", "Storage", "System",
              "Compute"]


@dataclasses.dataclass(frozen=True)
class IspCosts:
    """Calibrated per-op latency constants (us unless noted).

    Random-search fit against the paper's aggregate claims (see
    benchmarks/calibrate.py).  Achieved vs paper:
      D-VirtFW vs P.ISP 1.56x (1.6x) | vs D-Naive 1.76x (1.8x)
      vs D-FullOS 1.56x (1.6x) | vs Host 1.23x (1.3x)
      P.ISP-V 13.7% under P.ISP-R (13.7%) | D-FullOS +7.7% (9.3%)
      D-Naive +12.9% (12.8%) | Host storage share 40% (38%)
      P.ISP communicate share 42% (43%) | storage reduction 50% (50%).
    Deviation noted in EXPERIMENTS.md: our P.ISP beats Host on
    {nginx-filedown, vsftpd-fileup}; the paper lists
    {rocksdb-read, nginx-filedown}."""
    # storage paths
    host_io_us: float = 6.668        # host NVMe stack + PCIe per IO
    flash_io_us: float = 5.044       # internal flash access per IO
    host_bw_gbs: float = 2.866       # host-visible transfer bandwidth
    flash_bw_gbs: float = 12.143     # internal multi-channel bandwidth
    # compute
    ssd_slowdown: float = 1.5        # 2.2 GHz frontend vs 3.8 GHz host
    # system path
    host_syscall_us: float = HOST_SYSCALL_US
    embedded_syscall_us: float = EMBEDDED_SYSCALL_US
    virtfw_call_us: float = FUNC_CALL_US
    path_walk_us: float = 8.235      # host VFS path resolution
    virtfw_walk_us: float = 0.016    # λFS walk w/ I/O-node cache
    # network path
    host_net_pkt_us: float = 0.0745
    etheron_pkt_us: float = 6.448    # Ether-oN tunneled packet
    # ISP communicate path
    rpc_us: float = 15.191           # P.ISP-R per-offload RPC (Kernel-ctx)
    vendor_cmd_us: float = 3.099     # P.ISP-V vendor-specific command
    lba_set_us: float = 12.637       # per-IO LBA handshake batch share
    ctx_switch_us: float = CONTEXT_SWITCH_US
    intercomplex_us: float = 3.308   # D-Naive per-IO complex-to-complex hop
    offload_per_ios: float = 1663.0  # IOs batched per offload invocation


def host_components(w: Workload, c: IspCosts) -> Dict[str, float]:
    """Decompose the measured host runtime into components (seconds)."""
    storage = (w.io_count * c.host_io_us * 1e-6 +
               w.io_size_gb / c.host_bw_gbs)
    system = (w.syscalls * c.host_syscall_us +
              w.path_walks * c.path_walk_us) * 1e-6
    network = w.tcp_packets * c.host_net_pkt_us * 1e-6
    compute = max(w.exec_time_s - storage - system - network,
                  0.05 * w.exec_time_s)
    return {"Network": network, "Kernel-ctx": 0.0, "LBA-set": 0.0,
            "Storage": storage, "System": system, "Compute": compute}


def components(w: Workload, model: str,
               c: IspCosts = IspCosts()) -> Dict[str, float]:
    h = host_components(w, c)
    if model == "Host":
        return h
    compute_ssd = h["Compute"] * c.ssd_slowdown
    storage_int = (w.io_count * c.flash_io_us * 1e-6 +
                   w.io_size_gb / c.flash_bw_gbs)
    offloads = max(1.0, w.io_count / c.offload_per_ios)

    if model in ("P.ISP-R", "P.ISP-V"):
        per = c.rpc_us if model == "P.ISP-R" else c.vendor_cmd_us
        kernel_ctx = offloads * (per + 2 * c.ctx_switch_us) * 1e-6 * 1e3
        lba_set = w.io_count * c.lba_set_us * 1e-6
        # bare-metal kernels: no OS/syscall machinery on-device
        return {"Network": h["Network"], "Kernel-ctx": kernel_ctx,
                "LBA-set": lba_set, "Storage": storage_int,
                "System": 0.0, "Compute": compute_ssd}

    if model == "D-Naive":
        system = (w.syscalls * c.embedded_syscall_us +
                  w.path_walks * c.path_walk_us) * 1e-6
        inter = w.io_count * c.intercomplex_us * 1e-6 + \
            w.io_size_gb / c.flash_bw_gbs          # extra complex hop copy
        return {"Network": w.tcp_packets * c.etheron_pkt_us * 1e-6,
                "Kernel-ctx": 0.0, "LBA-set": 0.0,
                "Storage": storage_int + inter, "System": system,
                "Compute": compute_ssd}

    if model == "D-FullOS":
        system = (w.syscalls * c.embedded_syscall_us +
                  w.path_walks * c.path_walk_us) * 1e-6
        return {"Network": w.tcp_packets * c.etheron_pkt_us * 1e-6,
                "Kernel-ctx": 0.0, "LBA-set": 0.0, "Storage": storage_int,
                "System": system, "Compute": compute_ssd}

    if model == "D-VirtFW":
        system = (w.syscalls * c.virtfw_call_us +
                  w.path_walks * c.virtfw_walk_us) * 1e-6
        return {"Network": w.tcp_packets * c.etheron_pkt_us * 1e-6,
                "Kernel-ctx": 0.0, "LBA-set": 0.0, "Storage": storage_int,
                "System": system, "Compute": compute_ssd}
    raise ValueError(model)


def total(w: Workload, model: str, c: IspCosts = IspCosts()) -> float:
    return sum(components(w, model, c).values())


def workload_scan_gbs(program: str, name: str, c: IspCosts = IspCosts(),
                      *, scale: float = 8.0) -> float:
    """Per-byte compute intensity of a Table-2 workload, expressed as
    the effective host scan rate (GB/s) of its operator.

    Table 2 fixes the *relative* intensity: bytes touched divided by
    the Compute component of the decomposed host runtime
    (:func:`host_components`) — pattern matching burns more cycles per
    byte than TPC-H's semi-join counting.  The absolute scale belongs
    to the operator implementation, not the platform (the planner's
    ``scan_gbs`` default), so the relative intensity is normalized by
    the geometric mean across all Table-2 workloads and multiplied by
    ``scale``.  This is what threads into ``AnalyticsJob.scan_gbs`` so
    the :class:`~repro_torch.runtime.offload.OffloadPlanner`'s modeled
    ``host_s``/``dvirtfw_s`` differentiate workloads instead of pricing
    every scan identically."""
    import numpy as np
    w = next((w for w in WORKLOADS
              if w.program == program and w.name == name), None)
    if w is None:
        raise KeyError(f"no Table-2 workload {program}-{name}")
    intensity = lambda w: w.io_size_gb / host_components(w, c)["Compute"]
    ref = float(np.exp(np.mean([np.log(intensity(x)) for x in WORKLOADS])))
    return scale * intensity(w) / ref


def evaluate_all(c: IspCosts = IspCosts()):
    """Fig 11 data: components for every model x workload."""
    return {f"{w.program}-{w.name}": {m: components(w, m, c) for m in MODELS}
            for w in WORKLOADS}


def fig3_breakdown(c: IspCosts = IspCosts()):
    """Fig 3: Host vs P.ISP (avg across workloads), 3-component view."""
    import numpy as np
    rows = {}
    for model in ("Host", "P.ISP-V"):
        comp = store = comm = tot = 0.0
        for w in WORKLOADS:
            d = components(w, model, c)
            comp += d["Compute"] + d["System"]
            store += d["Storage"]
            comm += d["Network"] + d["Kernel-ctx"] + d["LBA-set"]
            tot += sum(d.values())
        rows[model] = {"Compute": comp, "Storage": store,
                       "Communicate": comm, "total": tot}
    return rows


def headline_ratios(c: IspCosts = IspCosts()) -> Dict[str, float]:
    import numpy as np
    g = lambda xs: float(np.exp(np.mean(np.log(xs))))
    t = {m: [total(w, m, c) for w in WORKLOADS] for m in MODELS}
    pisp = [(a + b) / 2 for a, b in zip(t["P.ISP-R"], t["P.ISP-V"])]
    r = {
        "dvirtfw_vs_pisp": g([a / b for a, b in zip(pisp, t["D-VirtFW"])]),
        "dvirtfw_vs_dnaive": g([a / b for a, b in
                                zip(t["D-Naive"], t["D-VirtFW"])]),
        "dvirtfw_vs_dfullos": g([a / b for a, b in
                                 zip(t["D-FullOS"], t["D-VirtFW"])]),
        "dvirtfw_vs_host": g([a / b for a, b in
                              zip(t["Host"], t["D-VirtFW"])]),
        "pispv_vs_pispr": 1.0 - g([a / b for a, b in
                                   zip(t["P.ISP-V"], t["P.ISP-R"])]),
        "dfullos_over_pispv": g([a / b for a, b in
                                 zip(t["D-FullOS"], t["P.ISP-V"])]) - 1.0,
        "dnaive_over_dfullos": g([a / b for a, b in
                                  zip(t["D-Naive"], t["D-FullOS"])]) - 1.0,
        "pisp_vs_host": g([a / b for a, b in zip(pisp, t["Host"])]),
    }
    # Fig 3 shares
    f3 = fig3_breakdown(c)
    r["host_storage_share"] = f3["Host"]["Storage"] / f3["Host"]["total"]
    r["pisp_comm_share"] = (f3["P.ISP-V"]["Communicate"] /
                            f3["P.ISP-V"]["total"])
    r["pisp_storage_reduction"] = 1.0 - (f3["P.ISP-V"]["Storage"] /
                                         f3["Host"]["Storage"])
    return r
