"""Zamba2-1.2B — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].

[hybrid] 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  One *shared* (weight-tied) attention+MLP block is
applied every ``attn_every`` Mamba2 blocks, following the Zamba2
design.  Sub-quadratic decode state -> runs long_500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    block_type="mamba2_hybrid",
    source="arXiv:2411.15242; hf",
)
