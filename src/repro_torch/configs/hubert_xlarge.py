"""HuBERT-XLarge — encoder-only audio transformer [arXiv:2106.07447].

[audio] 48L d_model=1280 16H (kv=16, MHA) d_ff=5120 vocab=504
(k-means target units). Same backbone as wav2vec2.  Encoder-only:
no decode step; decode-family shapes are skipped.  The CNN feature
extractor is a STUB per task spec: ``input_specs()`` provides
precomputed frame embeddings.  Non-causal; LayerNorm + plain GeLU MLP.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    act="gelu",
    norm="layernorm",
    rope=False,
    encoder_only=True,
    causal=False,
    frontend="audio",
    source="arXiv:2106.07447",
)
