"""Llama-4 Scout 17B-active / 16 experts — MoE decoder, early-fusion VLM
[hf:meta-llama/Llama-4-Scout-17B-16E].

[moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
MoE 16 experts top-1.  The early-fusion vision frontend is a STUB per
task spec (text path exercised; ``input_specs`` are token ids).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    n_experts=16,
    top_k=1,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
