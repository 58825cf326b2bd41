"""Granite-3.0-2B — dense GQA decoder [hf:ibm-granite/granite-3.0-2b-base].

[dense] 40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
head_dim = 2048/32 = 64; tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49_155,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
