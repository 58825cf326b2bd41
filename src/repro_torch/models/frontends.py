"""Modality frontends: stand-ins, as in the JAX package.

The ``[vlm]``/``[audio]`` archs (paligemma-3b, hubert-xlarge) specify the
transformer backbone only; the frontend (a SigLIP vision tower, a CNN
feature extractor) supplies precomputed patch or frame embeddings.
:func:`synth_embeddings` makes deterministic synthetic ones of the right
shape.  The reference's ``frontend_embed_spec`` (a shape stand-in for
its XLA dry run) has no counterpart here.
"""
from __future__ import annotations

import torch


def synth_embeddings(cfg, batch: int, seq: int,
                     generator: torch.Generator | None = None,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """[batch, seq, d_model] embeddings of ``0.02 * N(0, 1)``, drawn from
    ``generator`` (a ``torch.Generator`` on ``device``; seed 0 on the
    CPU when none is given).  The same distribution as the reference's;
    the numbers differ (different generators)."""
    if generator is None:
        generator = torch.Generator(device=device or "cpu").manual_seed(0)
    x = torch.empty((batch, seq, cfg.d_model), dtype=torch.float32,
                    device=device)
    x.normal_(0.0, 1.0, generator=generator)
    return x.mul_(0.02).to(dtype)
