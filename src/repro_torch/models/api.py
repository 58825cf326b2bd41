"""Model lookup: the port of ``repro.models.api.get_model`` for the
transformer and RWKV6 block types."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.rwkv6 import RWKV6LM
from repro_torch.models.transformer import TransformerLM


def get_model(cfg: ArchConfig, compute_dtype=torch.float32):
    if cfg.block_type == "rwkv6":
        return RWKV6LM(cfg, compute_dtype=compute_dtype)
    if cfg.block_type != "transformer":
        raise NotImplementedError(
            f"block_type {cfg.block_type!r}: not yet ported")
    return TransformerLM(cfg, compute_dtype=compute_dtype)
