"""Architecture + input-shape configuration registry.

A copy of the JAX package's registry (same fields, same ``reduced()``),
kept here so the port imports nothing of ``repro``.  Every architecture
is a frozen ``ArchConfig``; every input shape is a ``ShapeConfig``.
``cells()`` enumerates the runnable (arch x shape) grid with skip
annotations (encoder-only archs have no decode step; ``long_500k`` only
runs for sub-quadratic families).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Iterator, Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # defaults to d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | geglu | gelu (gelu = non-gated)
    rope: bool = True
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0              # hybrid: shared attn block period
    # structure
    block_type: str = "transformer"  # transformer | rwkv6 | mamba2_hybrid
    encoder_only: bool = False
    causal: bool = True
    frontend: Optional[str] = None   # vision | audio
    source: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Archs whose decode state does not grow O(seq * d): SSM/hybrid."""
        return self.block_type in ("rwkv6", "mamba2_hybrid")

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only

    def reduced(self) -> "ArchConfig":
        """CPU-smoke-test configuration of the same family (tiny dims)."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 if self.attn_every == 0 else max(2, self.attn_every)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=128,
            vocab_size=128,
            head_dim=16,
            n_experts=4 if self.n_experts else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.block_type in ("rwkv6", "mamba2_hybrid") else self.ssm_head_dim,
            attn_every=2 if self.attn_every else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "paligemma_3b",
    "hubert_xlarge",
    "qwen2_72b",
    "phi3_mini_3_8b",
    "granite_3_2b",
    "command_r_plus_104b",
    "llama4_scout_17b_a16e",
    "phi3_5_moe_42b_a6_6b",
    "rwkv6_3b",
    "zamba2_1_2b",
]

_REGISTRY: dict = {}


def get_arch(name: str) -> ArchConfig:
    """Look up an ArchConfig by id (accepts '-' or '_' separators)."""
    key = name.replace("-", "_").replace(".", "_")
    if key not in _REGISTRY:
        mod = importlib.import_module(f"repro_torch.configs.{key}")
        _REGISTRY[key] = mod.CONFIG
    return _REGISTRY[key]


def all_archs() -> list:
    return [get_arch(a) for a in ARCH_IDS]


def cell_status(arch: ArchConfig, shape: ShapeConfig) -> str:
    """'run' or a 'skip:<reason>' marker for an (arch, shape) cell."""
    if shape.kind == "decode" and not arch.has_decode:
        return "skip:encoder-only arch has no decode step"
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return "skip:long_500k requires sub-quadratic attention (full-attention arch)"
    return "run"


def cells(runnable_only: bool = True) -> Iterator[tuple]:
    """Yield (arch, shape, status) over the 10 x 4 assigned grid."""
    for aid in ARCH_IDS:
        arch = get_arch(aid)
        for shape in SHAPES.values():
            status = cell_status(arch, shape)
            if runnable_only and status != "run":
                continue
            yield arch, shape, status
