"""Model lookup: the transformer branch of ``repro.models.api.get_model``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import TransformerLM


def get_model(cfg: ArchConfig, compute_dtype=torch.float32) -> TransformerLM:
    if cfg.block_type != "transformer":
        raise NotImplementedError(
            f"block_type {cfg.block_type!r}: not yet ported")
    return TransformerLM(cfg, compute_dtype=compute_dtype)
