"""PaliGemma-3B — SigLIP + Gemma-2B decoder backbone [arXiv:2407.07726; hf].

[vlm] 18L d_model=2048 8H (GQA kv=1, i.e. MQA) d_ff=16384 vocab=257216.
Gemma uses head_dim=256 (8 x 256 = 2048), GeGLU MLP, RMSNorm.
The SigLIP vision frontend is a STUB per task spec: ``input_specs()``
provides precomputed patch embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257_216,
    head_dim=256,
    act="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    frontend="vision",
    source="arXiv:2407.07726; hf",
)
