"""Gradient compression with error feedback (the port of
``repro.optim.compression``): row-wise symmetric int8 or a bf16 round
trip, the residual of each step added to the next step's gradient.
``torch.round`` rounds half to even, as ``jnp.round`` does."""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map


def _quant_int8(x):
    """Row-wise symmetric int8 quantization.  x: f32[...]."""
    flat = x.reshape(x.shape[0], -1) if x.dim() > 1 else x.reshape(1, -1)
    scale = torch.amax(torch.abs(flat), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q, scale, shape):
    return (q.to(torch.float32) * scale).reshape(shape)


def compress_grads(grads, residuals, mode: str = "int8"):
    """Compress and decompress each gradient leaf with error feedback.
    Returns (decompressed grads, new residuals)."""
    if mode == "none":
        return grads, residuals
    if mode not in ("int8", "bf16"):
        raise ValueError(f"compression mode {mode!r}: none, bf16 or int8")

    def one(g, r):
        g32 = g.float() + r
        if mode == "bf16":
            out = g32.to(torch.bfloat16).float()
        else:
            q, s = _quant_int8(g32)
            out = _dequant_int8(q, s, g32.shape)
        return out.to(g.dtype), g32 - out

    pairs = tree_map(one, grads, residuals)
    return _part(pairs, 0), _part(pairs, 1)


def _part(pairs, i):
    if isinstance(pairs, dict):
        return {k: _part(v, i) for k, v in pairs.items()}
    return pairs[i]


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_bytes(params, mode: str) -> int:
    """Bytes the gradient all-reduce would move under ``mode``."""
    per = {"none": 4, "bf16": 2, "int8": 1}[mode]
    return sum(p.numel() * per for p in tree_leaves(params))
