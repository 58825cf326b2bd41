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
    the reference's ``einsum``), not on capacity-sized buffers;
  * tensor parallelism: the attention, MLP, embedding and unembedding
    functions take ``group``, the ``model`` axis of a mesh
    (``launch.mesh.MeshAxis``), and then hold this rank's shard of each
    weight, as ``runtime.sharding.param_spec`` places it: ``wq``, ``wk``,
    ``wv``, ``w_gate``, ``w_up`` by columns (this rank's heads and ffn
    columns), ``wo`` and ``w_down`` by rows (their outputs summed over
    the axis), the embedding table by vocabulary rows or, where the
    vocabulary does not divide, by ``d``.  The collectives that carry a
    gradient are Megatron's: :func:`copy_to_group` (identity, gradient
    summed), :func:`reduce_from_group` (summed, gradient identity) and
    :func:`gather_from_group` (all-gathered, gradient sliced).
    ``group=None`` is the one-process code path.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# collectives that carry a gradient (tensor parallelism over ``group``)
# ---------------------------------------------------------------------------


class _CopyToGroup(torch.autograd.Function):
    """Forward the identity, backward the gradient summed over the group:
    the input of a column-parallel product, replicated over the group,
    takes each rank's share of its gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g), None


class _ReduceFromGroup(torch.autograd.Function):
    """Forward the sum over the group, backward the identity: the output
    of a row-parallel product (each rank's partial sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """Forward every rank's slice joined along ``dim``, backward this
    rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.part(g, ctx.dim).contiguous(), None, None


def _alone(group) -> bool:
    return group is None or group.size == 1


def copy_to_group(x, group):
    return x if _alone(group) else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return x if _alone(group) else _ReduceFromGroup.apply(x, group)


def gather_from_group(x, group, dim: int):
    return x if _alone(group) else _GatherFromGroup.apply(x, group, dim)


def _local_cols(bias, n: int, group):
    """A replicated bias's columns of this rank's shard of a
    column-parallel product with ``n`` local columns (its gradient, zero
    past them, summed over the group: every rank's columns)."""
    if group is None or bias.shape[-1] == n:
        return bias
    return copy_to_group(bias, group).narrow(-1, group.index * n, n)


def split_to_group(x, group, dim: int):
    """This rank's ``1 / size`` slice along ``dim`` of a replicated ``x``
    (every rank's gradient of its slice summed: the whole gradient on
    every rank)."""
    if _alone(group):
        return x
    return group.part(copy_to_group(x, group), dim)


def col_full(x, w, group, split: bool):
    """The whole ``x @ w`` on every rank, its gradient whole too: over
    ``group``, ``w`` split by columns (``split``) gives this rank's
    columns, gathered; else every rank computes the product."""
    if _alone(group) or not split:
        return x @ w.to(x.dtype)
    return gather_from_group(copy_to_group(x, group) @ w.to(x.dtype),
                             group, -1)


def whole_param(w, group, dim: int, split: bool):
    """A param that this rank uses only in part, whole: gathered along
    ``dim`` where ``split``, and through :func:`copy_to_group` (each
    rank's part of its gradient summed, then this rank's slice kept)."""
    if _alone(group):
        return w
    return copy_to_group(gather_from_group(w, group, dim) if split else w,
                         group)


# ---------------------------------------------------------------------------
# products remat "dots" recomputes
# ---------------------------------------------------------------------------

_UNSAVED = contextvars.ContextVar("unsaved", default=False)


@contextlib.contextmanager
def unsaved():
    """Products run inside are ones the reference's remat "dots"
    (``checkpoint_dots_with_no_batch_dims``) does not keep, though they
    reach the dispatcher as a 2-D ``mm`` (``transformer.dots_policy``
    reads :func:`saving`): the FFN's down product, whose output no
    backward rule reads (JAX's partial evaluation drops it), and the MoE
    experts' products, batched einsums in the reference."""
    token = _UNSAVED.set(True)
    try:
        yield
    finally:
        _UNSAVED.reset(token)


def saving() -> bool:
    """Whether a product run now may be kept (outside :func:`unsaved`)."""
    return not _UNSAVED.get()


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



def _qkv(p, x, cfg, group=None):
    """q [B, S, H, D], k/v [B, S, Hkv, D]; over ``group`` this rank's
    heads (H / n and Hkv / n: its columns of wq, wk, wv)."""
    b, s, _ = x.shape
    hd = cfg.hd
    x = copy_to_group(x, group)
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + _local_cols(p["bq"], q.shape[-1], group).to(x.dtype)
        k = k + _local_cols(p["bk"], k.shape[-1], group).to(x.dtype)
        v = v + _local_cols(p["bv"], v.shape[-1], group).to(x.dtype)
    return (q.reshape(b, s, -1, hd), k.reshape(b, s, -1, hd),
            v.reshape(b, s, -1, hd))


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


def attention_block(p, x, cfg, group=None):
    """Full (forward / prefill) attention incl. projections.  Returns
    (attn_out [B, S, d], k, v [B, S, Hkv, D] after RoPE: what prefill
    caches).  Over ``group`` the flash kernels run on this rank's heads
    and k, v are this rank's heads; ``wo``'s partial sums are reduced."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, group)
    if cfg.rope:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = chunked_attention(q, k, v, causal=cfg.causal)
    out = out.reshape(b, s, -1) @ p["wo"].to(x.dtype)
    return reduce_from_group(out, group), k, v


def decode_attention(p, x, cfg, k_cache, v_cache, index: int, group=None,
                     seq=None):
    """One-token decode against a dense KV cache, in plain torch.

    x: [B, 1, d]; k_cache/v_cache: [B, Hkv, S, D], written in place at
    position ``index`` (the JAX package returns updated copies; its
    serving step donates the old ones).  Returns (attn_out [B, 1, d],
    k_cache, v_cache).  A bf16 cache is up-cast to f32 for the products,
    as jnp's type promotion does.  Over ``group`` (the heads' axis) and
    ``seq`` (the sequence's, ``group`` where not given) the cache is this
    rank's sequence extent of every head (:func:`_dcache_step`, the
    D-Cache schedule)."""
    if group is not None or seq is not None:
        return _dcache_step(p, x, cfg, (k_cache, v_cache), index, group,
                            seq or group)
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


def _dcache_step(p, x, cfg, cache, index: int, group, seq):
    """One decode token with the KV cache sequence-sharded over ``seq``:
    the paper's D-Cache schedule (the reference's ``decode_attention``
    under its cache placement).  ``group`` is the heads' axis (the mesh's
    ``model``, or None), ``seq`` the sequence's (``model``, or ``(pod,
    model)``: the pod ranks of one ``(data, model)`` coordinate hold the
    same rows and compute the same q; only their extents differ).

    ``cache``: (k, v) [B, Hkv, S / |seq|, D], this rank's extent of every
    head (positions ``seq.index * S / |seq|`` on), or for int8 (k, v,
    k_scale, v_scale).  The projections give this rank's heads; q and
    the new k, v (B x H x D floats) are gathered over ``group``, the new
    position (and its scales) written only on the rank that owns
    ``index``.  Each rank scores every head over its extent, masked
    ``<= index``:

      * f32 / bf16 cache: the partial ``(acc, m, l)`` merged by
        ``runtime.serve.combine_partials`` over ``seq``;
      * int8 cache: the global max and sum first (``all_reduce`` MAX,
        then SUM over ``seq``), the weights normalised before they are
        rounded to bf16 with ``v_scale`` folded in (the reference rounds
        its normalised ``probs * v_scale``), and the partial outputs
        summed.

    This rank's heads of the merged output go through its rows of
    ``wo``, summed over ``group``.  Returns (attn_out [B, 1, d], *cache).
    """
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    quant = len(cache) == 4
    k_cache, v_cache = cache[:2]
    sl = k_cache.shape[2]
    start = seq.index * sl
    n = 1 if group is None else group.size
    q, k, v = _qkv(p, x, cfg, group)                     # this rank's heads
    if cfg.rope:
        pos = torch.full((b, 1), index, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    kv = torch.cat([k, v], dim=2)
    if n > 1:
        q = group.all_gather(q, 2)                       # [B, 1, H, D]
        kv = group.all_gather(kv, 2)                     # each rank's k, v
    kv = kv.reshape(b, 1, n, 2, hkv // n, hd)
    k = kv[:, 0, :, 0].reshape(b, hkv, hd)
    v = kv[:, 0, :, 1].reshape(b, hkv, hd)
    if start <= index < start + sl:
        at = index - start
        if quant:
            for i, t in ((0, k), (1, v)):
                code, scale = quantize_kv(t)
                cache[i][:, :, at] = code
                cache[2 + i][:, :, at] = scale
        else:
            k_cache[:, :, at] = k.to(k_cache.dtype)
            v_cache[:, :, at] = v.to(v_cache.dtype)
    qg = q.reshape(b, hkv, h // hkv, hd)
    valid = start + torch.arange(sl, device=x.device) <= index
    if quant:
        logits = torch.einsum("bhgd,bhsd->bhgs", _bf16_f32(qg),
                              k_cache.float())
        logits = logits * cache[2][:, :, None, :] / math.sqrt(hd)
    else:
        logits = torch.einsum("bhgd,bhsd->bhgs", qg.float(),
                              k_cache.float()) / math.sqrt(hd)
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    m = logits.amax(dim=-1)
    if not quant:
        e = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
        acc = torch.einsum("bhgs,bhsd->bhgd", e, v_cache.float())
        from repro_torch.runtime.serve import combine_partials
        out = combine_partials(acc, m, e.sum(dim=-1), group=seq)
    else:
        m = seq.all_reduce(m, "max")
        e = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
        probs = e / seq.all_reduce(e.sum(dim=-1))[..., None]
        w = _bf16_f32(probs * cache[3][:, :, None, :])
        out = seq.all_reduce(torch.einsum("bhgs,bhsd->bhgd", w,
                                          v_cache.float()))
    if n > 1:
        out = out.reshape(b, n, -1)[:, group.index]
    out = out.to(x.dtype).reshape(b, 1, -1) @ p["wo"].to(x.dtype)
    return (reduce_from_group(out, group), *cache)


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
                        index: int, group=None, seq=None):
    """``decode_attention`` over an int8 KV cache.

    k_cache/v_cache: int8 [B, Hkv, S, D]; k_scale/v_scale: f32 [B, Hkv,
    S]; the new position is quantized and written in place at ``index``.
    Operands go to bf16 with f32 sums, and the scales fold in the
    reference's order: ``logits * k_scale / sqrt(D)``, then ``probs *
    v_scale`` before the bf16 cast.  Returns (attn_out [B, 1, d],
    k_cache, v_cache, k_scale, v_scale).  Over ``group`` and ``seq``:
    this rank's sequence extent (:func:`_dcache_step`)."""
    if group is not None or seq is not None:
        return _dcache_step(p, x, cfg, (k_cache, v_cache, k_scale, v_scale),
                            index, group, seq or group)
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


def apply_mlp(p, x, act, group=None):
    """The MLP; over ``group`` this rank's ffn columns (``w_gate``,
    ``w_up``) and rows (``w_down``), the output summed over the group."""
    x = copy_to_group(x, group)
    if "w_gate" not in p:
        up = x @ p["w_up"].to(x.dtype)
        h = F.gelu(up + _local_cols(p["b_up"], up.shape[-1], group)
                   .to(x.dtype), approximate="tanh")
        with unsaved():
            down = h @ p["w_down"].to(x.dtype)
        return reduce_from_group(down, group) + p["b_down"].to(x.dtype)
    h = _gate_act(x @ p["w_gate"].to(x.dtype), act) * (x @ p["w_up"].to(x.dtype))
    with unsaved():
        down = h @ p["w_down"].to(x.dtype)
    return reduce_from_group(down, group)


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


#: MoE routing counts, summed over every routed call while not None
#: (``moe_drops(True)``): pairs routed, pairs dropped past capacity, and
#: ``kept_sig``, the sum of ``(token * k + slot) * E + expert`` over the
#: pairs this rank's experts keep (equal sums: the same routing)
MOE_DROPS = None


def moe_drops(on: bool = True):
    """Start (``on``) or stop counting the (token, slot) pairs routed and
    dropped by every MoE call; returns the counts so far (a Counter, or
    None when off).  The count rides on the routing's one host read."""
    global MOE_DROPS
    was = MOE_DROPS
    MOE_DROPS = collections.Counter() if on else None
    return was


def moe_route(p, xt, cfg, capacity: int, data=None, mean=None):
    """The reference's token-choice top-k routing of ``xt`` [T, d].

    Ties go to the lower expert id (a stable descending sort, as
    ``lax.top_k`` breaks them); the top-k weights are renormalised; a
    token's place in slot j's buffer of its expert is its rank among the
    tokens routed there in slot j, in token order, and it is dropped at
    ``pos >= capacity``.  Returns (topv [T, k] f32, topi [T, k], keep
    [T, k] bool, the Switch-style aux loss over ``topi[:, 0]``).

    Over ``data`` (the axis a mesh's batch rows split over, each rank
    holding its rows of the global batch in index order) the routing is
    the global batch's, the one GSPMD gives the reference: a token's
    place adds the exclusive prefix of the (slot, expert) counts of the
    ranks before this one.  Over ``mean`` (``data`` where not given:
    every rank whose gradients the step sums, which may hold the same
    rows as another, ``(pod, data)`` when the rows split over ``pod``
    alone) ``aux`` takes the global means of the first slot's density
    and of the probabilities, each over ``T x |mean|`` tokens, so a row
    held twice counts twice on both sides of the mean (the
    probabilities' sum reduced with :func:`reduce_from_group`: each
    rank's gradient is its tokens')."""
    e, k = cfg.n_experts, cfg.top_k
    logits = (xt @ p["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / topv.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(topi, e)                               # [T, k, E]
    pos = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1
    first = F.one_hot(topi[:, 0], e).float()
    mean = data if mean is None else mean
    if not _alone(data):
        every = data.all_gather(onehot.sum(dim=0)[None], 0)  # [n, k, E]
        before = every[:data.index].sum(dim=0)
        pos = pos + (onehot * before[None]).sum(dim=-1)
    if _alone(mean):
        density, proxy = first.mean(dim=0), probs.mean(dim=0)
    else:
        t_all = xt.shape[0] * mean.size
        density = mean.all_reduce(first.sum(dim=0)) / t_all
        proxy = reduce_from_group(probs.sum(dim=0), mean) / t_all
    aux = torch.sum(density * proxy) * (e ** 2) / e
    return topv, topi, pos < capacity, aux


def _expert_rows(p, xt, cfg, topv, topi, keep, ep=None):
    """``Σ_j topv[:, j] * expert_{topi[:, j]}(x)`` over the kept pairs, each
    expert's three products on its own rows.  ``p`` holds every expert,
    or over ``ep`` (the model axis splitting them) this rank's ``E / n``
    from ``index * E / n``: its pairs' rows, the partial outputs summed
    over ``ep`` (x and the top-k weights take ``copy_to_group``: each
    rank's experts give part of their gradients)."""
    t, d = xt.shape
    k = cfg.top_k
    n = p["w_gate"].shape[0]
    lo = 0 if _alone(ep) else ep.index * n
    mine = keep & (topi >= lo) & (topi < lo + n)
    # pairs t*k + j sorted by expert, the others (id n) last
    eid = torch.where(mine, topi - lo, n).reshape(-1)
    order = torch.argsort(eid, stable=True)
    tally = [torch.bincount(eid, minlength=n + 1)]
    if MOE_DROPS is not None:
        pair = torch.arange(t * k, device=xt.device).reshape(t, k)
        tally += [(~keep).sum().reshape(1), torch.where(
            mine, pair * cfg.n_experts + topi, 0).sum().reshape(1)]
    counts = torch.cat(tally).tolist()
    if MOE_DROPS is not None:
        MOE_DROPS["pairs"] += t * k
        MOE_DROPS["dropped"] += counts[n + 1]
        MOE_DROPS["kept_sig"] += counts[n + 2]
    kept = order[:t * k - counts[n]]
    xe = copy_to_group(xt, ep)
    rows = xe[kept // k]
    ys = []
    for i, (rows_e, wg, wu, wd) in enumerate(zip(rows.split(counts[:n]),
                                                 p["w_gate"].unbind(0),
                                                 p["w_up"].unbind(0),
                                                 p["w_down"].unbind(0))):
        # an expert without rows is skipped, but for the last one where
        # none had rows: its empty products keep ``xe`` and the weights
        # in the graph, so every rank's backward takes a (zero) gradient
        # of each leaf and runs the all-reduce of ``xe``'s over ``ep``
        if rows_e.shape[0] or (not ys and i == n - 1):
            with unsaved():
                h = (_gate_act(rows_e @ wg.to(xt.dtype), cfg.act) *
                     (rows_e @ wu.to(xt.dtype)))
                ys.append(h @ wd.to(xt.dtype))
    y = xt.new_zeros((t * k, d)).index_copy(0, kept, torch.cat(ys))
    y = y.reshape(t, k, d)
    tv = copy_to_group(topv, ep)
    out = xt.new_zeros((t, d))
    for j in range(k):
        out = out + y[:, j] * tv[:, j:j + 1].to(xt.dtype)
    return reduce_from_group(out, ep)


def _expert_axis(p, cfg, place):
    """The axis splitting the experts on a mesh: ``model`` where this
    rank holds ``E / model`` of them, else none (every rank all)."""
    return place.model if p["w_gate"].shape[0] < cfg.n_experts else None


def apply_moe(p, x, cfg, capacity=None, no_drop: bool = False,
              place=None, rows=None):
    """Token-choice top-k MoE.  x: [B, S, d].  Returns (out, aux).

    Routing is the reference's (:func:`moe_route`).  Dispatch differs:
    the (token, slot) pairs each expert keeps are gathered, sorted by
    expert, and each expert runs its three products on its own rows, so
    the work is the routed rows', not E capacity-sized buffers'.  A
    dropped pair adds nothing; the slots are summed in order j = 0..k-1,
    each weighted by its ``topv``, as the reference sums them.  One host
    read a call: the rows each expert keeps.

    On a mesh (``place``, a ``launch.mesh.MeshPlacement``; ``x`` this
    rank's rows of the batch, split over ``rows``, an axis of
    ``place.rows_axis`` or None for every row, and replicated over
    ``model``) the result is the reference's GSPMD one, the one-process
    routing of the global batch: the capacity from the global token count
    (``T x |rows|``), places ranked over ``rows`` (:func:`moe_route`),
    the global aux's means over every ``(pod, data)`` rank
    (``place.fsdp``); the experts as ``param_specs`` places them (``E ->
    model``), each rank running its own on its rows and the outputs
    summed over ``model``."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    if place is None:
        topv, topi, keep, aux = moe_route(
            p, xt, cfg, moe_capacity(cfg, t, capacity, no_drop))
        return _expert_rows(p, xt, cfg, topv, topi, keep).reshape(
            b, s, d), aux
    cap = moe_capacity(cfg, t * (1 if rows is None else rows.size),
                       capacity, no_drop)
    topv, topi, keep, aux = moe_route(p, xt, cfg, cap, rows, place.fsdp)
    out = _expert_rows(p, xt, cfg, topv, topi, keep,
                       _expert_axis(p, cfg, place))
    return out.reshape(b, s, d), aux


def apply_moe_shardmap(p, x, cfg, no_drop: bool = False, place=None):
    """The reference's explicit-schedule MoE (``apply_moe_shardmap``): on
    a mesh each ``(pod, data)`` rank routes its own tokens with the local
    capacity ``int(cf * T_local * k / E)`` (``T_local`` under
    ``no_drop``), each model rank runs its ``E / model`` experts on their
    rows (the weights arrive whole over ``(pod, data)`` from the FSDP
    gather), the outputs are summed over ``model`` and ``aux`` is the
    local Switch loss averaged over ``(pod, data)`` (the reference's
    ``fsdp = ("pod", "data")``).  Where a token is dropped this is a
    different result from :func:`apply_moe` on the mesh (global
    capacity); the two agree under ``no_drop`` or with one ``(pod,
    data)`` rank.
    Outside a mesh, on a mesh without a ``model`` axis, or where the
    experts do not split over it, it runs :func:`apply_moe`, as the
    reference falls back.  Returns (out, aux)."""
    if place is None:
        return apply_moe(p, x, cfg, no_drop=no_drop)
    if "model" not in place.names or cfg.n_experts % place.sizes["model"]:
        return apply_moe(p, x, cfg, no_drop=no_drop, place=place)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    topv, topi, keep, aux = moe_route(p, xt, cfg,
                                      moe_capacity(cfg, t, None, no_drop))
    out = _expert_rows(p, xt, cfg, topv, topi, keep, place.model)
    aux = reduce_from_group(aux, place.fsdp) / place.fsdp.size
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


def embed_tokens(p, tokens, compute_dtype, group=None, split=None):
    """Rows of the table.  Over ``group``, ``split`` is the table dim its
    spec splits over the group: 0, this rank's vocabulary rows (a token
    outside them looks up zeros, and the rows are summed over the
    group), or 1, this rank's columns of d (gathered over the group)."""
    if group is None:
        return p["table"][tokens].to(compute_dtype)
    table = p["table"]
    if split == 1:
        return gather_from_group(table[tokens].to(compute_dtype), group, -1)
    n = table.shape[0]
    local = tokens - group.index * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].to(compute_dtype)
    return reduce_from_group(torch.where(inside[..., None], rows, 0.0),
                             group)


def unembed(p_embed, p_head, x, tie: bool, group=None, split=None):
    """f32 logits [..., V].  Over ``group``, ``split`` is the dim of the
    table (tied) or of ``lm_head`` its spec splits over the group: by
    vocabulary (the table's 0, lm_head's 1) each rank's logits are
    gathered; by d (the table's 1, lm_head's 0) each rank's partial
    product over its columns of ``x`` is summed over the group."""
    if tie:
        w = p_embed["table"].to(x.dtype).T
    else:
        w = p_head["w"].to(x.dtype)
    if group is None:
        return (x @ w).float()
    x = copy_to_group(x, group)
    if split == (0 if tie else 1):
        return gather_from_group((x @ w).float(), group, -1)
    return reduce_from_group((group.part(x, -1) @ w).float(), group)


def nll_sum(logits, labels, ignore_id: int = -1):
    """(summed next-token NLL in f32, count) over labels != ``ignore_id``.
    logits: [..., V] f32; labels: integer [...]."""
    mask = (labels != ignore_id).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long())
    return torch.sum((lse - gold[..., 0]) * mask), torch.sum(mask)


def cross_entropy(logits, labels, ignore_id: int = -1, data=None):
    """Mean next-token CE in f32 over labels != ``ignore_id``; over
    ``data`` (a mesh's data axis, each rank its rows) the mean over every
    rank's valid labels."""
    nll, count = nll_sum(logits, labels, ignore_id)
    if not _alone(data):
        nll, count = reduce_from_group(nll, data), data.all_reduce(count)
    return nll / torch.clamp(count, min=1.0)
