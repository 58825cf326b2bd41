"""Qwen2-72B — dense GQA decoder with QKV bias [arXiv:2407.10671; hf].

[dense] 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29_568,
    vocab_size=152_064,
    qkv_bias=True,
    source="arXiv:2407.10671; hf",
)
