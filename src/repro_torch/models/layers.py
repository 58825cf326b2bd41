"""Shared neural building blocks on torch tensors (functional, dict params).

Mirrors ``repro.models.layers`` with the same layouts, so the parity
tests compare like with like:
  * params are nested dicts of tensors; per-layer blocks are stacked
    along a leading layer dim;
  * weights are ``[d_in, d_out]`` and used as ``x @ w``;
  * softmax and norms run in f32;
  * prefill and full-forward attention go through the flash-attention
    kernel (``kernels.ops.flash_attention``); one-token decode attention
    stays plain torch, as the JAX package computes it with ``einsum``
    outside any kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init, drawn from ``generator`` (which
    must live on ``device``).  ``in_axis`` indexes the per-layer shape,
    so a stacked ``[L, d_in, d_out]`` tensor takes ``in_axis=-2``."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=generator)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(d: int, kind: str, *, lead=(), dtype=torch.float32,
              device=None):
    """Norm params: ``scale`` ones (and ``bias`` zeros for layernorm) of
    shape ``lead + (d,)`` (``lead=(n_layers,)`` for a stacked block)."""
    shape = (*lead, d)
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def apply_norm(p, x, kind, eps=1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + eps) * p["scale"].float()
        out = out + p["bias"].float()
    return out.to(x.dtype)


def group_norm_heads(x, scale, eps=1e-5):
    """Per-head group norm of the RWKV6 wkv output.  x: [..., H, D]."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings (split-halves convention, not interleaved)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: [B, S, H, D]; positions: [B, S] (or [S]) integer."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # [D/2]
    ang = positions[..., None].float() * freqs             # [B, S, D/2]
    cos = torch.cos(ang)[..., None, :]                     # [B, S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention projections
# ---------------------------------------------------------------------------


def _qkv(p, x, cfg):
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(b, s, h, hd), k.reshape(b, s, hkv, hd),
            v.reshape(b, s, hkv, hd))


def chunked_attention(q, k, v, *, causal: bool):
    """Prefill / full-sequence GQA attention over positions 0..S-1 on
    both sides (the only way the JAX package's prefill, forward and loss
    call its ``chunked_attention``), through the flash-attention kernel.
    q: [B, S, H, D]; k/v: [B, S, Hkv, D].  Returns [B, S, H, D].

    When an input needs a gradient (training), the call goes through
    ``ops.flash_attention_with_grad`` (the forward kernel with the row
    logsumexp, and the backward kernels); otherwise through the
    forward-only ``ops.flash_attention``, as serving calls it."""
    args = [t.transpose(1, 2).float().contiguous() for t in (q, k, v)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        out = ops.flash_attention_with_grad(*args, causal=causal)
    else:
        out = ops.flash_attention(*args, causal=causal)
    return out.transpose(1, 2).to(q.dtype)


def attention_block(p, x, cfg):
    """Full (forward / prefill) attention incl. projections.  Returns
    (attn_out [B, S, d], k, v [B, S, Hkv, D] after RoPE: what prefill
    caches)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = chunked_attention(q, k, v, causal=cfg.causal)
    return out.reshape(b, s, -1) @ p["wo"].to(x.dtype), k, v


def decode_attention(p, x, cfg, k_cache, v_cache, index: int):
    """One-token decode against a dense KV cache, in plain torch.

    x: [B, 1, d]; k_cache/v_cache: [B, Hkv, S, D], written in place at
    position ``index`` (the JAX package returns updated copies; its
    serving step donates the old ones).  Returns (attn_out [B, 1, d],
    k_cache, v_cache).  A bf16 cache is up-cast to f32 for the products,
    as jnp's type promotion does."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = k_cache.shape[2]
    q, k, v = _qkv(p, x, cfg)                                  # [B,1,*,D]
    if cfg.rope:
        pos = torch.full((b, 1), index, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    k_cache[:, :, index] = k[:, 0].to(k_cache.dtype)
    v_cache[:, :, index] = v[:, 0].to(v_cache.dtype)
    qg = q.reshape(b, hkv, h // hkv, hd)
    logits = torch.einsum("bhgd,bhsd->bhgs", qg.float(),
                          k_cache.float()) / math.sqrt(hd)
    valid = torch.arange(s, device=x.device) <= index
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    vv = v_cache.to(torch.promote_types(probs.dtype, v_cache.dtype))
    out = torch.einsum("bhgs,bhsd->bhgd", probs.to(vv.dtype), vv)
    out = out.reshape(b, 1, h * hd).to(x.dtype) @ p["wo"].to(x.dtype)
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# MLP (gated / plain)
# ---------------------------------------------------------------------------


def _gate_act(x, act):
    if act == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")   # geglu; jax.nn.gelu's default


def apply_mlp(p, x, act):
    if "w_gate" not in p:
        h = F.gelu(x @ p["w_up"].to(x.dtype) + p["b_up"].to(x.dtype),
                   approximate="tanh")
        return h @ p["w_down"].to(x.dtype) + p["b_down"].to(x.dtype)
    h = _gate_act(x @ p["w_gate"].to(x.dtype), act) * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def embed_tokens(p, tokens, compute_dtype):
    return p["table"][tokens].to(compute_dtype)


def unembed(p_embed, p_head, x, tie: bool):
    if tie:
        w = p_embed["table"].to(x.dtype).T
    else:
        w = p_head["w"].to(x.dtype)
    return (x @ w).float()


def nll_sum(logits, labels, ignore_id: int = -1):
    """(summed next-token NLL in f32, count) over labels != ``ignore_id``.
    logits: [..., V] f32; labels: integer [...]."""
    mask = (labels != ignore_id).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long())
    return torch.sum((lse - gold[..., 0]) * mask), torch.sum(mask)


def cross_entropy(logits, labels, ignore_id: int = -1):
    """Mean next-token CE in f32 over labels != ``ignore_id``."""
    nll, count = nll_sum(logits, labels, ignore_id)
    return nll / torch.clamp(count, min=1.0)
