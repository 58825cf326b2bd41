"""Public kernel entry points of the port and their launch counts.

The runtime calls the kernels through this module.  A wrapper launches
its CUDA kernel for tensors on the card and runs its plain version
(``kernels.ref``) for tensors on the CPU; see ``kernels.paged_attention``,
``kernels.isp_scan``, ``kernels.embed_agg``, ``kernels.flash_attention``
(with its training forward and backward) and ``kernels.rwkv_scan``
(the same).
The ``*_host`` folds are the host-reads-everything path of the offload
planner: the plain fold over a fetched extent, bit-identical to the
in-storage kernels.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import embed_agg as _embed
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import isp_scan as _isp
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv_scan as _rwkv
from repro_torch.kernels.embed_agg import (embed_agg, embed_gather,
                                           validate_embed_args)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                  flash_attention_bwd,
                                                  flash_attention_lse,
                                                  flash_attention_with_grad)
from repro_torch.kernels.isp_scan import scan_filter_reduce, topk_scan
from repro_torch.kernels.paged_attention import (paged_attention,
                                                  paged_attention_pool,
                                                  paged_attention_pool_q8,
                                                  paged_attention_q8,
                                                  pool_partials)
from repro_torch.kernels.ref import (REDUCE_ROWS, scan_filter_reduce_host,
                                     topk_pad, topk_scan_host)
from repro_torch.kernels.rwkv_scan import (rwkv_scan, rwkv_scan_bwd,
                                           rwkv_scan_states,
                                           rwkv_scan_with_grad)

__all__ = ["paged_attention", "paged_attention_q8", "paged_attention_pool",
           "paged_attention_pool_q8", "pool_partials", "scan_filter_reduce",
           "scan_filter_reduce_host", "topk_scan", "topk_scan_host",
           "embed_agg", "embed_gather", "validate_embed_args",
           "flash_attention", "flash_attention_lse", "flash_attention_bwd",
           "flash_attention_with_grad", "rwkv_scan",
           "rwkv_scan_states", "rwkv_scan_bwd", "rwkv_scan_with_grad",
           "REDUCE_ROWS", "topk_pad", "launch_counts",
           "reset_launch_counts", "ref"]

#: one counter per compiled kernel, owned by each wrapper module
_COUNTERS = (_paged.LAUNCHES, _isp.LAUNCHES, _embed.LAUNCHES,
             _flash.LAUNCHES, _rwkv.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Snapshot of the kernel launch counters, keyed by kernel."""
    return {k: v for counter in _COUNTERS for k, v in counter.items()}


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for name in counter:
            counter[name] = 0
