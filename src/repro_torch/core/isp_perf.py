"""Calibrated per-operation costs of the ISP data-processing models.

The port's copy of ``IspCosts`` from ``repro.core.isp_perf`` (Figures 3
and 11, Table 2 of the paper), the constants the
:class:`~repro_torch.runtime.offload.OffloadPlanner` prices a job with.
The six models and the Table-2 workloads wait for the port of
``core/analytical.py``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.virtual_fw import (CONTEXT_SWITCH_US,
                                         EMBEDDED_SYSCALL_US, FUNC_CALL_US,
                                         HOST_SYSCALL_US)


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
