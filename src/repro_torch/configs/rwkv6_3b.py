"""RWKV-6 'Finch' 3B — attention-free RNN with data-dependent decay
[arXiv:2404.05892; hf].

[ssm] 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536.
Head size 64 -> 40 heads; decode state is O(1) in sequence length,
so this arch runs the long_500k shape.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # d_model / ssm_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65_536,
    ssm_head_dim=64,
    rope=False,
    norm="layernorm",
    block_type="rwkv6",
    source="arXiv:2404.05892; hf",
)
