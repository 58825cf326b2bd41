"""Shared neural building blocks on torch tensors (functional, dict params).

Mirrors ``repro.models.layers`` with the same layouts, so the parity
tests compare like with like:
  * params are nested dicts of tensors; per-layer blocks are stacked
    along a leading layer dim;
  * weights are ``[d_in, d_out]`` and used as ``x @ w``;
  * softmax and norms run in f32;
  * prefill and full-forward attention go through the flash-attention
    kernel (``kernels.ops.flash_attention``); one-token decode attention
    (f32/bf16 or int8 cache) stays plain torch, as the JAX package
    computes it with ``einsum`` outside any kernel;
  * the MoE FFN routes as the reference's ``apply_moe`` does and runs
    each expert's products on its kept rows only (``torch.matmul``, as
    the reference's ``einsum``), not on capacity-sized buffers.
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
# attention
# ---------------------------------------------------------------------------


def init_attention(generator, cfg, *, lead=(), dtype=torch.float32,
                   device=None):
    """GQA projections of shape ``lead + ...`` (fan-in init; zero QKV
    biases where ``cfg.qkv_bias``)."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kw = dict(dtype=dtype, device=device)
    p = {"wq": dense_init(generator, (*lead, d, h * hd), **kw),
         "wk": dense_init(generator, (*lead, d, hkv * hd), **kw),
         "wv": dense_init(generator, (*lead, d, hkv * hd), **kw),
         "wo": dense_init(generator, (*lead, h * hd, d), **kw)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, h * hd), **kw)
        p["bk"] = torch.zeros((*lead, hkv * hd), **kw)
        p["bv"] = torch.zeros((*lead, hkv * hd), **kw)
    return p



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


def quantize_kv(x):
    """Symmetric per-token int8 quantization over the last dim.
    x: [..., D] float -> (int8 codes [..., D], f32 scale [...])."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _bf16_f32(x):
    """``x`` rounded to bf16, back in f32: the reference's bf16 operands
    with f32 accumulation (``preferred_element_type``).  Products of
    bf16 values are exact in f32, so an f32 product of the rounded
    operands is that product; a bf16 ``einsum`` would round its output."""
    return x.to(torch.bfloat16).float()


def decode_attention_q8(p, x, cfg, k_cache, v_cache, k_scale, v_scale,
                        index: int):
    """``decode_attention`` over an int8 KV cache.

    k_cache/v_cache: int8 [B, Hkv, S, D]; k_scale/v_scale: f32 [B, Hkv,
    S]; the new position is quantized and written in place at ``index``.
    Operands go to bf16 with f32 sums, and the scales fold in the
    reference's order: ``logits * k_scale / sqrt(D)``, then ``probs *
    v_scale`` before the bf16 cast.  Returns (attn_out [B, 1, d],
    k_cache, v_cache, k_scale, v_scale)."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = k_cache.shape[2]
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope:
        pos = torch.full((b, 1), index, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    kq, ks = quantize_kv(k[:, 0])                        # [B,Hkv,D],[B,Hkv]
    vq, vs = quantize_kv(v[:, 0])
    k_cache[:, :, index] = kq
    v_cache[:, :, index] = vq
    k_scale[:, :, index] = ks
    v_scale[:, :, index] = vs
    qg = q.reshape(b, hkv, h // hkv, hd)
    logits = torch.einsum("bhgd,bhsd->bhgs", _bf16_f32(qg), k_cache.float())
    logits = logits * k_scale[:, :, None, :] / math.sqrt(hd)
    valid = torch.arange(s, device=x.device) <= index
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    pw = probs * v_scale[:, :, None, :]
    out = torch.einsum("bhgs,bhsd->bhgd", _bf16_f32(pw), v_cache.float())
    out = out.to(x.dtype).reshape(b, 1, h * hd) @ p["wo"].to(x.dtype)
    return out, k_cache, v_cache, k_scale, v_scale


# ---------------------------------------------------------------------------
# MLP (gated / plain) and MoE
# ---------------------------------------------------------------------------


def _gate_act(x, act):
    if act == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")   # geglu; jax.nn.gelu's default


def init_mlp(generator, cfg, *, lead=(), dtype=torch.float32, device=None):
    """A gated MLP (``w_gate``, ``w_up``, ``w_down``), or for ``act ==
    "gelu"`` a plain one with biases, of shape ``lead + ...``."""
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    if cfg.act == "gelu":
        return {"w_up": dense_init(generator, (*lead, d, f), **kw),
                "b_up": torch.zeros((*lead, f), **kw),
                "w_down": dense_init(generator, (*lead, f, d), **kw),
                "b_down": torch.zeros((*lead, d), **kw)}
    return {"w_gate": dense_init(generator, (*lead, d, f), **kw),
            "w_up": dense_init(generator, (*lead, d, f), **kw),
            "w_down": dense_init(generator, (*lead, f, d), **kw)}


def apply_mlp(p, x, act):
    if "w_gate" not in p:
        h = F.gelu(x @ p["w_up"].to(x.dtype) + p["b_up"].to(x.dtype),
                   approximate="tanh")
        return h @ p["w_down"].to(x.dtype) + p["b_down"].to(x.dtype)
    h = _gate_act(x @ p["w_gate"].to(x.dtype), act) * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


def init_moe(generator, cfg, *, lead=(), dtype=torch.float32, device=None):
    """MoE params of shape ``lead + ...``: the router [d, E] and each
    expert's gated MLP, ``w_gate``/``w_up`` [E, d, f], ``w_down`` [E, f,
    d] (fan-in d, d and f, as the reference's ``init_moe``)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    kw = dict(in_axis=-2, dtype=dtype, device=device)
    return {"router": dense_init(generator, (*lead, d, e), **kw),
            "w_gate": dense_init(generator, (*lead, e, d, f), **kw),
            "w_up": dense_init(generator, (*lead, e, d, f), **kw),
            "w_down": dense_init(generator, (*lead, e, f, d), **kw)}


def moe_capacity(cfg, t: int, capacity=None, no_drop: bool = False) -> int:
    """Rows an expert keeps a slot: every token with ``no_drop``, else
    ``capacity`` or ``int(capacity_factor * T * k / E)`` (at least 1)."""
    if no_drop:
        return t
    if capacity is None:
        capacity = max(int(cfg.capacity_factor * t * cfg.top_k /
                           cfg.n_experts), 1)
    return capacity


def moe_route(p, xt, cfg, capacity: int):
    """The reference's token-choice top-k routing of ``xt`` [T, d].

    Ties go to the lower expert id (a stable descending sort, as
    ``lax.top_k`` breaks them); the top-k weights are renormalised; a
    token's place in slot j's buffer of its expert is its rank among the
    tokens routed there in slot j, in token order, and it is dropped at
    ``pos >= capacity``.  Returns (topv [T, k] f32, topi [T, k], keep
    [T, k] bool, the Switch-style aux loss over ``topi[:, 0]``)."""
    e, k = cfg.n_experts, cfg.top_k
    logits = (xt @ p["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / topv.sum(dim=-1, keepdim=True)
    density = F.one_hot(topi[:, 0], e).float().mean(dim=0)
    aux = torch.sum(density * probs.mean(dim=0)) * (e ** 2) / e
    onehot = F.one_hot(topi, e)                               # [T, k, E]
    pos = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1
    return topv, topi, pos < capacity, aux


def apply_moe(p, x, cfg, capacity=None, no_drop: bool = False):
    """Token-choice top-k MoE.  x: [B, S, d].  Returns (out, aux).

    Routing is the reference's (:func:`moe_route`).  Dispatch differs:
    the (token, slot) pairs each expert keeps are gathered, sorted by
    expert, and each expert runs its three products on its own rows, so
    the work is the routed rows', not E capacity-sized buffers'.  A
    dropped pair adds nothing; the slots are summed in order j = 0..k-1,
    each weighted by its ``topv``, as the reference sums them.  One host
    read a call: the rows each expert keeps."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    topv, topi, keep, aux = moe_route(
        p, xt, cfg, moe_capacity(cfg, t, capacity, no_drop))
    # pairs t*k + j sorted by expert, the dropped ones (id e) last
    eid = torch.where(keep, topi, e).reshape(-1)
    order = torch.argsort(eid, stable=True)
    counts = torch.bincount(eid, minlength=e + 1).tolist()
    kept = order[:t * k - counts[e]]
    rows = xt[kept // k]
    ys = []
    for rows_e, wg, wu, wd in zip(rows.split(counts[:e]),
                                  p["w_gate"].unbind(0),
                                  p["w_up"].unbind(0),
                                  p["w_down"].unbind(0)):
        if rows_e.shape[0]:
            h = (_gate_act(rows_e @ wg.to(x.dtype), cfg.act) *
                 (rows_e @ wu.to(x.dtype)))
            ys.append(h @ wd.to(x.dtype))
    y = x.new_zeros((t * k, d)).index_copy(0, kept, torch.cat(ys))
    y = y.reshape(t, k, d)
    out = x.new_zeros((t, d))
    for j in range(k):
        out = out + y[:, j] * topv[:, j:j + 1].to(x.dtype)
    return out.reshape(b, s, d), aux


def apply_moe_dense(p, x, cfg, capacity=None, no_drop: bool = False):
    """The reference's dense dispatch, kept as the plain version that
    :func:`apply_moe` is held to: each slot scatters its kept tokens into
    [E, capacity + 1, d] buffers (the last row takes the dropped ones)
    and every expert runs over its whole buffer.  Returns (out, aux)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    cap = moe_capacity(cfg, t, capacity, no_drop)
    topv, topi, _, aux = moe_route(p, xt, cfg, cap)
    out = x.new_zeros((t, d))
    for j in range(k):
        eid = topi[:, j]
        onehot = F.one_hot(eid, e)
        pos = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1
        keep = pos < cap
        slot = torch.where(keep, pos, cap)
        buf = x.new_zeros((e, cap + 1, d))
        buf = buf.index_put((eid, slot), torch.where(keep[:, None], xt, 0),
                            accumulate=True)[:, :cap]
        h = _gate_act(torch.einsum("ecd,edf->ecf", buf,
                                   p["w_gate"].to(x.dtype)), cfg.act)
        h = h * torch.einsum("ecd,edf->ecf", buf, p["w_up"].to(x.dtype))
        y = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(x.dtype))
        y = torch.cat([y, y.new_zeros((e, 1, d))], dim=1)
        out = out + y[eid, slot] * topv[:, j:j + 1].to(x.dtype)
    return out.reshape(b, s, d), aux


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
