"""Public kernel entry points of the port and their launch counts.

The serving runtime calls the kernels through this module.  A wrapper
launches its CUDA kernel for tensors on the card and runs its plain
version (``kernels.ref``) for tensors on the CPU; see
``kernels.paged_attention``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import ref  # noqa: F401  (plain versions)
from repro_torch.kernels.paged_attention import (LAUNCHES, paged_attention,
                                                  paged_attention_q8)

__all__ = ["paged_attention", "paged_attention_q8", "launch_counts",
           "reset_launch_counts", "ref"]


def launch_counts() -> Dict[str, int]:
    """Snapshot of the kernel launch counters, keyed by kernel."""
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
