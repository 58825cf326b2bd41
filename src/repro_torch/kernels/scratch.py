"""Scratch buffers that the hand-written kernels keep between launches.

``merge_tickets``: the tickets of a kernel whose last block of a group
merges the group's shares (the pool forms of ``csrc/paged_attention.cu``,
the dK/dV shares of ``csrc/flash_attention_bwd.cu``): one zeroed uint32 a
group of blocks, a buffer a (device, stream) grown to the largest grid
launched on it.  The last block of each group resets its ticket, so the
buffer stays zeroed between launches.
"""
from __future__ import annotations

import torch

_TICKETS = {}


def merge_tickets(device, stream: int, need: int):
    """A zeroed int32 buffer of at least ``need`` tickets for a launch on
    ``stream``."""
    key = (device.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(1 << max(need - 1, 1).bit_length(),
                          dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf
