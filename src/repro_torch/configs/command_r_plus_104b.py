"""Command-R+ 104B — dense GQA decoder, no biases
[hf:CohereForAI/c4ai-command-r-v01].

[dense] 64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
head_dim = 128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33_792,
    vocab_size=256_000,
    head_dim=128,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
