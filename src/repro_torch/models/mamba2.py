"""Mamba2 (SSD) blocks and the Zamba2 hybrid LM (a Mamba2 backbone with
one *shared*, weight-tied attention block applied every ``attn_every``
layers; arXiv:2411.15242), the port of ``repro.models.mamba2``.

The SSD scan is the chunked parallel form with a scalar decay a head;
every exponent is a difference of cumulative log-decays (<= 0, so f32
holds it).  The JAX package runs it in ``einsum``s outside any kernel,
and so does the port, in plain torch; the shared block's prefill
attention goes through the flash-attention kernel
(``layers.chunked_attention``; under a gradient the kernel's training
forward and its backward), its decode through
``layers.decode_attention``.  Decode is the O(1)-state recurrence.
``loss`` is the reference's cross-entropy over the full logits; under
``remat="full"`` (or "dots", the same here) each mamba layer is
recomputed in the backward pass, as the reference checkpoints its
``mamba_fn`` (the shared block is not).
The SSD scan, the conv and the gates take their gradient by autograd, as
the reference's take theirs by autodiff: no Pallas kernel covers them.
Params use the reference's layout (``layers`` stacked along a leading
``n_layers`` dim, ``shared_attn`` unstacked, an untied ``lm_head``), so
weights convert one to one (``models.convert``).

``Zamba2LM.on_mesh(mesh)`` places the model on a ``(pod, data, model)``
mesh: the batch's rows over ``(pod, data)``, FSDP as
``runtime.sharding.param_specs`` places the weights, and tensor
parallelism by heads over ``model`` (:class:`MambaTP`; the shared block
as the dense transformer's); decode's rows over ``data``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.transformer import (REMAT, MeshModel, _needs_grad,
                                            layer_params, unbind_layers)

D_CONV = 4


# ---------------------------------------------------------------------------
# SSD scan (scalar decay a head)
# ---------------------------------------------------------------------------


def ssd_chunk(cb, x, dt, da, h0):
    """One chunk, batched over leading dims (the reference's one (batch,
    head) under ``vmap``).

    cb: (C, B) each [..., Ck, ds] (broadcast over heads); x: [..., Ck,
    dh]; dt, da (<= 0): [..., Ck]; h0: [..., dh, ds].  Returns (y [...,
    Ck, dh], the state after the chunk)."""
    cm, bm = cb
    ck = x.shape[-2]
    cum = torch.cumsum(da, dim=-1)                         # [..., Ck]
    decay = cum[..., :, None] - cum[..., None, :]          # t, s
    mask = torch.tril(torch.ones((ck, ck), dtype=torch.bool,
                                 device=x.device))
    # mask before exp: exp of the (positive) upper triangle would overflow
    dmat = torch.exp(torch.where(mask, decay, -math.inf))
    scores = (cm @ bm.transpose(-1, -2)) * dmat            # [..., t, s]
    xin = x * dt[..., None]
    y = scores @ xin
    y = y + torch.exp(cum)[..., None] * (cm @ h0.transpose(-1, -2))
    w = torch.exp(cum[..., -1:] - cum)
    h_c = (torch.exp(cum[..., -1])[..., None, None] * h0 +
           (w[..., None] * xin).transpose(-1, -2) @ bm)
    return y, h_c


def ssd_chunked(x, dt, da, bm, cm, h0, chunk: int = 64):
    """x: [B, S, H, dh]; dt, da: [B, S, H]; bm, cm: [B, S, ds]; h0: [B, H,
    dh, ds].  Returns (y [B, S, H, dh], the final state).  S must be a
    multiple of the chunk (the reference asserts it).

    :func:`ssd_chunk`'s arithmetic, with every chunk's own terms computed
    at once and the carried state stepped chunk by chunk."""
    b, s, h, dh = x.shape
    ds = bm.shape[-1]
    ck = min(chunk, s)
    if s % ck:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {ck}")
    n = s // ck
    xs = x.reshape(b, n, ck, h, dh).transpose(2, 3)        # [B,N,H,Ck,dh]
    dts = dt.reshape(b, n, ck, h).transpose(2, 3)          # [B,N,H,Ck]
    das = da.reshape(b, n, ck, h).transpose(2, 3)
    bs = bm.reshape(b, n, 1, ck, ds)
    cs = cm.reshape(b, n, 1, ck, ds)
    cum = torch.cumsum(das, dim=-1)
    mask = torch.tril(torch.ones((ck, ck), dtype=torch.bool,
                                 device=x.device))
    dmat = torch.exp(torch.where(mask, cum[..., :, None] - cum[..., None, :],
                                 -math.inf))
    xin = xs * dts[..., None]
    y = ((cs @ bs.transpose(-1, -2)) * dmat) @ xin         # [B,N,H,Ck,dh]
    w = torch.exp(cum[..., -1:] - cum)
    contrib = (w[..., None] * xin).transpose(-1, -2) @ bs  # [B,N,H,dh,ds]
    decay = torch.exp(cum[..., -1])[..., None, None]       # [B,N,H,1,1]
    states, state = [], h0
    for i in range(n):
        states.append(state)
        state = decay[:, i] * state + contrib[:, i]
    h_in = torch.stack(states, dim=1)                      # [B,N,H,dh,ds]
    y = y + torch.exp(cum)[..., None] * (cs @ h_in.transpose(-1, -2))
    return y.transpose(2, 3).reshape(b, s, h, dh), state


def ssd_step(x, dt, da, bm, cm, state):
    """One token.  x: [B, H, dh]; dt, da: [B, H]; bm, cm: [B, ds]; state:
    [B, H, dh, ds].  Returns (y [B, H, dh], new state)."""
    xin = x * dt[..., None]
    new = (torch.exp(da)[..., None, None] * state +
           xin[..., :, None] * bm[:, None, None, :])
    y = torch.einsum("bhds,bs->bhd", new, cm)
    return y, new


def ssd_ref(x, dt, da, bm, cm, h0):
    """Per-token oracle: :func:`ssd_step` over the sequence."""
    state, ys = h0, []
    for t in range(x.shape[1]):
        y, state = ssd_step(x[:, t], dt[:, t], da[:, t], bm[:, t], cm[:, t],
                            state)
        ys.append(y)
    return torch.stack(ys, dim=1), state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def mamba2_dims(cfg):
    """(d_inner, SSM heads, conv channels)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim, d_inner + 2 * cfg.ssm_state


def init_mamba2(generator, cfg, *, lead=(), dtype=torch.float32,
                device=None):
    """Mamba2 params of shape ``lead + ...``, the reference's shapes and
    init distributions."""
    d = cfg.d_model
    d_inner, n_heads, conv_dim = mamba2_dims(cfg)
    d_proj = 2 * d_inner + 2 * cfg.ssm_state + n_heads
    kw = dict(dtype=dtype, device=device)
    in_proj = L.dense_init(generator, (*lead, d, d_proj), **kw)
    conv_w = torch.empty((*lead, D_CONV, conv_dim), device=device)
    conv_w.normal_(0.0, 1.0, generator=generator)
    a_log = torch.log(torch.linspace(1.0, 8.0, n_heads, device=device))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.mul_(0.1).to(dtype),
        "conv_b": torch.zeros((*lead, conv_dim), **kw),
        "a_log": a_log.expand(*lead, n_heads).to(dtype).clone(),
        "d_skip": torch.ones((*lead, n_heads), **kw),
        "dt_bias": torch.zeros((*lead, n_heads), **kw),
        "gate_norm": {"scale": torch.ones((*lead, d_inner), **kw)},
        "out_proj": L.dense_init(generator, (*lead, d_inner, d), **kw),
    }


def _split_proj(cfg, zxbcdt):
    """in_proj's output -> (z, xBC, dt)."""
    d_inner, n_heads, conv_dim = mamba2_dims(cfg)
    return zxbcdt.split([d_inner, conv_dim, n_heads], dim=-1)


def _causal_conv(xbc, w, bias):
    """Depthwise causal conv over the sequence.  xbc: [B, S, C]; w:
    [D_CONV, C]."""
    pad = F.pad(xbc, (0, 0, D_CONV - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i][None, None, :]
              for i in range(D_CONV))
    return F.silu(out + bias[None, None, :])


def _dt_da(p, dt):
    """softplus(dt + dt_bias) in f32, and the log-decay -exp(a_log) * dt."""
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["a_log"].float()) * dt


class MambaTP(NamedTuple):
    """A Mamba2 block's tensor parallelism over ``group`` (a mesh's
    ``model`` axis): this rank runs ``H / n`` of the SSM heads.
    ``in_proj`` packs ``z | x | B | C | dt``, so a contiguous split of its
    columns (``in_split``, as ``param_spec`` places it) mixes the parts:
    its product is gathered whole and each rank takes its heads' ``z``,
    ``x`` and ``dt`` and all of ``B`` and ``C``, which every head shares;
    ``conv_w`` over the conv channels (``conv_split``) likewise, gathered
    and sliced to those channels.  ``gate_norm`` normalises over the
    whole ``d_inner``: the sum of squares is all-reduced.  ``out_proj``
    splits by rows, its output summed over the axis."""
    group: Any
    in_split: bool
    conv_split: bool


def _tp_parts(p, x, cfg, tp: Optional[MambaTP]):
    """(z, xBC, dt, conv_w, conv_b, the head params {a_log, d_skip,
    dt_bias}, gate scale) of this rank's heads: its ``x`` channels and
    all of ``B`` and ``C`` in xBC and the conv's weights (every head in
    one process)."""
    d_inner, n_heads, conv_dim = mamba2_dims(cfg)
    heads = {k: p[k] for k in ("a_log", "d_skip", "dt_bias")}
    if tp is None:
        z, xbc, dt = _split_proj(cfg, x @ p["in_proj"].to(x.dtype))
        return (z, xbc, dt, p["conv_w"], p["conv_b"], heads,
                p["gate_norm"]["scale"])
    g = tp.group
    dl, lo = d_inner // g.size, g.index * (d_inner // g.size)
    whole = L.copy_to_group(L.col_full(x, p["in_proj"], g, tp.in_split), g)
    z, xbc, dt = _split_proj(cfg, whole)
    chans = torch.cat([torch.arange(lo, lo + dl, device=x.device),
                       torch.arange(d_inner, conv_dim, device=x.device)])
    conv_w = L.whole_param(p["conv_w"], g, -1, tp.conv_split)
    conv_b = L.whole_param(p["conv_b"], g, -1, False)
    return (z.narrow(-1, lo, dl), xbc.index_select(-1, chans),
            g.part(dt, -1), conv_w.index_select(-1, chans),
            conv_b.index_select(-1, chans),
            {k: L.split_to_group(v, g, -1) for k, v in heads.items()},
            L.split_to_group(p["gate_norm"]["scale"], g, -1))


def _gate_out(p, y, z, scale, tp: Optional[MambaTP], eps: float = 1e-6):
    """``rmsnorm(y * silu(z)) @ out_proj``: over ``tp`` the sum of squares
    over the whole ``d_inner`` all-reduced (its gradient too) and the
    row-parallel product summed."""
    if tp is None:
        y = L.apply_norm({"scale": scale}, y * F.silu(z), "rmsnorm")
        return y @ p["out_proj"].to(y.dtype)
    g = tp.group
    gz = (y * F.silu(z)).float()
    ss = L.copy_to_group(L.reduce_from_group(
        gz.square().sum(-1, keepdim=True), g), g)
    var = ss / (gz.shape[-1] * g.size)
    y = (gz * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)
    return L.reduce_from_group(y @ p["out_proj"].to(y.dtype), g)


def apply_mamba2_seq(p, x, cfg, conv_state, ssm_state, chunk: int = 64,
                     tp: Optional[MambaTP] = None):
    """x: [B, S, d]; conv_state: [B, D_CONV - 1, conv_dim], prepended to
    the conv's input; ssm_state: [B, H, dh, ds].  Returns (out,
    new conv state, new ssm state).  Over ``tp`` the states are this
    rank's: the conv's its heads' x channels and B, C; the SSM's its
    heads."""
    b, s, _ = x.shape
    ds, dh = cfg.ssm_state, cfg.ssm_head_dim
    z, xbc, dt, conv_w, conv_b, hp, scale = _tp_parts(p, x, cfg, tp)
    full = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    conv = _causal_conv(full, conv_w.to(x.dtype),
                        conv_b.to(x.dtype))[:, D_CONV - 1:]
    new_conv = full[:, -(D_CONV - 1):]
    xs, bm, cm = conv.split([conv.shape[-1] - 2 * ds, ds, ds], dim=-1)
    xs = xs.reshape(b, s, -1, dh)
    dt, da = _dt_da(hp, dt)
    y, h_t = ssd_chunked(xs.float(), dt, da, bm.float(), cm.float(),
                         ssm_state, chunk=chunk)
    y = y + xs.float() * hp["d_skip"].float()[:, None]
    y = y.reshape(b, s, -1).to(x.dtype)
    return _gate_out(p, y, z, scale, tp), new_conv, h_t


def apply_mamba2_step(p, x, cfg, conv_state, ssm_state,
                      tp: Optional[MambaTP] = None):
    """x: [B, d], one token; conv_state: [B, D_CONV - 1, conv_dim].
    Returns (out [B, d], new conv state, new ssm state); over ``tp``
    this rank's states, as :func:`apply_mamba2_seq`'s."""
    b, _ = x.shape
    ds, dh = cfg.ssm_state, cfg.ssm_head_dim
    z, xbc, dt, conv_w, conv_b, hp, scale = _tp_parts(p, x, cfg, tp)
    window = torch.cat([conv_state.to(xbc.dtype), xbc[:, None, :]], dim=1)
    conv = torch.sum(window * conv_w.to(x.dtype)[None], dim=1)
    xbc = F.silu(conv + conv_b.to(x.dtype))
    xs, bm, cm = xbc.split([xbc.shape[-1] - 2 * ds, ds, ds], dim=-1)
    xs = xs.reshape(b, -1, dh).float()
    dt, da = _dt_da(hp, dt)
    y, new_ssm = ssd_step(xs, dt, da, bm.float(), cm.float(), ssm_state)
    y = y + xs * hp["d_skip"].float()[:, None]
    y = y.reshape(b, -1).to(x.dtype)
    return _gate_out(p, y, z, scale, tp), window[:, 1:], new_ssm


# ---------------------------------------------------------------------------
# Zamba2 hybrid LM
# ---------------------------------------------------------------------------


class Zamba2LM(MeshModel):
    """Mamba2 backbone; ONE shared attention + MLP block applied before
    each group of ``attn_every`` mamba layers (weight-tied across its
    applications, each application keeping its own KV cache).  The
    shared block applies RoPE whatever ``cfg.rope`` says and uses
    rmsnorm throughout, as the reference's does.  Its weights are one
    set of leaves, so autograd sums the gradients of its applications.
    ``remat`` is "none" or, for "full" and "dots" alike, each mamba layer
    recomputed whole in the backward pass: the reference checkpoints its
    ``mamba_fn`` with no policy for any value but "none", so "dots" means
    "full" here too."""

    def __init__(self, cfg, compute_dtype=torch.float32, chunk: int = 64,
                 remat: str = "full", loss_chunk: int = 256,
                 q_chunk: int = 1024, unroll_inner: bool = False):
        """The reference's keywords, with its defaults: ``loss_chunk`` is
        unread in the reference too (its loss is the CE over the full
        logits), ``q_chunk`` the query chunk of the reference's
        ``chunked_attention`` where the port runs the flash kernel, and
        ``unroll_inner`` the unroll of its inner ``lax.scan`` (an XLA
        compile option): kept, read nowhere."""
        if remat not in REMAT:
            raise ValueError(f"remat {remat!r}: the port takes "
                             f"{', '.join(REMAT)}")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.chunk = chunk
        self.remat = remat
        self.loss_chunk = loss_chunk
        self.q_chunk = q_chunk
        self.unroll = unroll_inner
        self.groups = [(i, min(i + cfg.attn_every, cfg.n_layers))
                       for i in range(0, cfg.n_layers, cfg.attn_every)]
        self.n_attn = len(self.groups)
        # the placement (on_mesh): none in one process
        self.place = self.tp = self.seq = self.rows = None
        self.specs = self.mtp = None
        self.embed_split = self.head_split = None

    def on_mesh(self, mesh):
        """This model placed on ``mesh`` (``transformer.place_model``):
        its methods take this rank's params, gathered over the FSDP axes,
        and its rows of a batch (``rows``, ``transformer.MeshModel``);
        ``loss`` is the mean over every ``(pod, data)`` rank's valid
        labels.  Over ``model`` each mamba layer runs ``H / model`` SSM
        heads (:class:`MambaTP`) and the shared block runs as the dense
        transformer's (its heads and ffn columns; the gradient of its
        weights sums over its applications).  The decode cache holds this
        rank's decode rows, over ``data`` (the pod ranks of one ``(data,
        model)`` coordinate hold the same rows and run the same mamba
        steps): the shared block's K/V its extent of the sequence over
        ``(pod, model)``, every head (the D-Cache placement of
        ``cache_spec_shardings``); the conv state its heads' x channels
        and B, C [L, B, D_CONV - 1, d_inner / model + 2 ds], the SSM state
        its heads [L, B, H / model, dh, ds].  ``cache_spec_shardings``
        splits the states' rows over ``(pod, data)`` and their last dims,
        ``conv_dim`` and ``ds``: one cache cannot put the K/V's rows and
        the states' rows on different ranks, so the states follow the
        K/V's rows, and a head split is not ``ds``'s (ROADMAP §C; the
        values are the reference's).  ``gather_cache`` gives the whole
        cache.  Raises ``NotImplementedError`` where a head count or a
        product does not split over ``model``."""
        from repro_torch.models.transformer import place_model, split_over

        cfg = self.cfg
        placed = place_model(self, mesh)
        n = placed.place.sizes["model"]
        if n > 1:
            sp, mb = placed.specs["shared_attn"], placed.specs["layers"][
                "mamba"]
            want = [("attn", w, -1) for w in ("wq", "wk", "wv")] + [
                ("attn", "wo", -2), ("mlp", "w_down", -2)] + [
                ("mlp", w, -1) for w in ("w_gate", "w_up") if w in sp["mlp"]]
            bad = [f"shared_attn/{blk}/{w}" for blk, w, d in want
                   if not split_over(sp[blk][w], d)]
            if not split_over(mb["out_proj"], -2):
                bad.append("mamba/out_proj")
            heads = mamba2_dims(cfg)[1]
            if heads % n or cfg.n_heads % n or cfg.n_kv_heads % n or bad:
                raise NotImplementedError(
                    f"{cfg.name} over model = {n}: the SSM heads ({heads}), "
                    f"the attention heads ({cfg.n_heads}/{cfg.n_kv_heads}) "
                    f"or the products {bad} do not split over the model "
                    "axis")
            placed.mtp = MambaTP(placed.tp, split_over(mb["in_proj"], -1),
                                 split_over(mb["conv_w"], -1))
        return placed

    def gather_cache(self, cache, batch: int):
        """The whole cache of a global batch of ``batch`` rows from this
        rank's, on every rank of a placed model."""
        tp = self.tp
        out = dict(cache)
        if self.seq is not None:
            out.update(k=self.seq.all_gather(cache["k"], 3),
                       v=self.seq.all_gather(cache["v"], 3))
        if tp is not None:
            ds = self.cfg.ssm_state
            conv = cache["conv"]
            xs = tp.all_gather(conv[..., :conv.shape[-1] - 2 * ds], -1)
            out.update(conv=torch.cat([xs, conv[..., -2 * ds:]], dim=-1),
                       ssm=tp.all_gather(cache["ssm"], 2))
        for k in ("k", "v", "conv", "ssm"):
            out[k] = self._gather_rows(out[k], batch)
        return out

    def _dims(self):
        """(conv channels, SSM heads) of this rank."""
        d_inner, n_heads, conv_dim = mamba2_dims(self.cfg)
        n = 1 if self.place is None else self.place.sizes["model"]
        return conv_dim - d_inner + d_inner // n, n_heads // n

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Dict[str, Any]:
        """Random params on ``device``, drawn from ``generator``: the JAX
        ``Zamba2LM.init``'s tree, shapes and distributions; the numbers
        differ (different generators)."""
        cfg = self.cfg
        n, d = cfg.n_layers, cfg.d_model
        kw = dict(dtype=dtype, device=device)
        shared = {"attn_norm": L.init_norm(d, "rmsnorm", **kw),
                  "attn": L.init_attention(generator, cfg, **kw),
                  "mlp_norm": L.init_norm(d, "rmsnorm", **kw),
                  "mlp": L.init_mlp(generator, cfg, **kw)}
        layers = {"norm": L.init_norm(d, "rmsnorm", lead=(n,), **kw),
                  "mamba": init_mamba2(generator, cfg, lead=(n,), **kw)}
        return {
            "embed": {"table": L.embed_init(generator, (cfg.vocab_size, d),
                                            **kw)},
            "shared_attn": shared,
            "layers": layers,
            "final_norm": L.init_norm(d, "rmsnorm", **kw),
            "lm_head": {"w": L.dense_init(generator, (d, cfg.vocab_size),
                                         **kw)},
        }

    # -- shared attention block ------------------------------------------------

    def _shared_attn_seq(self, sp, h, cache_dtype=None, cache_len=None):
        """The shared block over positions 0..S-1, attention through the
        flash kernel.  Returns (h, k and v [B, Hkv, S, D] in
        ``cache_dtype``, zeros past S to ``cache_len`` positions where
        given; none without a dtype).  On a mesh this rank's heads, its
        products' partial sums reduced; the K/V its extent of the
        positions, every head."""
        cfg, tp = self.cfg, self.tp
        b, s, _ = h.shape
        a = L.apply_norm(sp["attn_norm"], h, "rmsnorm")
        q, k, v = L._qkv(sp["attn"], a, cfg, tp)
        positions = torch.arange(s, device=h.device)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        o = L.chunked_attention(q, k, v, causal=True)
        h = h + L.reduce_from_group(
            o.reshape(b, s, -1) @ sp["attn"]["wo"].to(h.dtype), tp)
        m = L.apply_norm(sp["mlp_norm"], h, "rmsnorm")
        h = h + L.apply_mlp(sp["mlp"], m, cfg.act, tp)
        if cache_dtype is None:
            return h, None, None
        return (h, self._cache_kv(k, cache_dtype, cache_len),
                self._cache_kv(v, cache_dtype, cache_len))

    def _cache_kv(self, k, cache_dtype, cache_len):
        if self.tp is not None:
            k = self.tp.all_gather(k, 2)
        k = k.transpose(1, 2)
        if cache_len is not None and cache_len > k.shape[2]:
            k = F.pad(k, (0, 0, 0, cache_len - k.shape[2]))
        return self._seq_extent(k, 2).to(cache_dtype)

    def _shared_attn_step(self, sp, h, kc, vc, index: int):
        """The shared block on one token; writes its K/V into ``kc``/``vc``
        [B, Hkv, S, D] at ``index``."""
        cfg = self.cfg
        a = L.apply_norm(sp["attn_norm"], h, "rmsnorm")
        h = h + L.decode_attention(sp["attn"], a, cfg, kc, vc, index,
                                   self.tp, self.seq)[0]
        m = L.apply_norm(sp["mlp_norm"], h, "rmsnorm")
        return h + L.apply_mlp(sp["mlp"], m, cfg.act, self.tp)

    # -- full sequence ---------------------------------------------------------

    def _mamba_layer(self, h, lp, conv_state, ssm_state):
        """One mamba layer with its residual.  Returns (h, conv state,
        ssm state)."""
        a = L.apply_norm(lp["norm"], h, "rmsnorm")
        o, conv, ssm = apply_mamba2_seq(lp["mamba"], a, self.cfg, conv_state,
                                        ssm_state, chunk=self.chunk,
                                        tp=self.mtp)
        return h + o, conv, ssm

    def _run(self, params, h, cache_dtype=None, cache_len=None):
        """The groups over positions 0..S-1 from zero states.  Returns
        (h after the final norm, the state: k/v [n_attn, B, Hkv, S, D]
        in ``cache_dtype``, conv [n_layers, B, D_CONV - 1, conv_dim] and
        ssm [n_layers, B, H, dh, ds]; no k/v without a cache dtype).
        When the params need a gradient the mamba layers come from
        ``unbind_layers``, each recomputed in the backward pass unless
        ``remat="none"``."""
        cfg = self.cfg
        b = h.shape[0]
        conv_dim, n_heads = self._dims()
        conv0 = torch.zeros((b, D_CONV - 1, conv_dim), device=h.device)
        ssm0 = torch.zeros((b, n_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           device=h.device)
        train = torch.is_grad_enabled() and _needs_grad(params["layers"])
        layers = (unbind_layers(params["layers"], cfg.n_layers) if train
                  else [layer_params(params["layers"], li)
                        for li in range(cfg.n_layers)])
        ks, vs, convs, ssms = [], [], [], []
        for lo, hi in self.groups:
            h, k, v = self._shared_attn_seq(params["shared_attn"], h,
                                            cache_dtype, cache_len)
            ks.append(k)
            vs.append(v)
            for li in range(lo, hi):
                if train and self.remat != "none":
                    h, conv, ssm = checkpoint(self._mamba_layer, h,
                                              layers[li], conv0, ssm0,
                                              use_reentrant=False)
                else:
                    h, conv, ssm = self._mamba_layer(h, layers[li], conv0,
                                                     ssm0)
                convs.append(conv)
                ssms.append(ssm)
        h = L.apply_norm(params["final_norm"], h, "rmsnorm")
        state = {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}
        if cache_dtype is not None:
            state.update(k=torch.stack(ks), v=torch.stack(vs))
        return h, state

    def _embed(self, params, tokens):
        return L.embed_tokens(params["embed"], tokens, self.compute_dtype,
                              self.tp, self.embed_split)

    def _head(self, params, h):
        return L.unembed(None, params["lm_head"], h, False, self.tp,
                         self.head_split)

    def forward(self, params, batch):
        """Full logits for ``batch["tokens"]`` [B, S].  Returns (logits
        f32 [B, S, V], aux = 0)."""
        h = self._embed(params, batch["tokens"])
        h, _ = self._run(params, h)
        return self._head(params, h), torch.zeros((), device=h.device)

    def loss(self, params, batch):
        """(ce, {"ce", "aux": 0}) for ``batch["tokens"]`` and
        ``batch["labels"]`` [B, S] (label -1: not counted), as the
        reference's ``loss``; on a mesh the mean over every data rank's
        labels."""
        logits, _ = self.forward(params, batch)
        ce = L.cross_entropy(logits, batch["labels"], data=self.place and
                             self.place.fsdp)
        return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}

    # -- serving ----------------------------------------------------------------
    #
    # The cache is {"k", "v": [n_attn, B, Hkv, S, D], "conv": [n_layers, B,
    # D_CONV - 1, conv_dim], "ssm": [n_layers, B, H, dh, ds], "index": int},
    # ``index`` a host int; ``decode_step`` writes the tensors in place.

    def cache_spec(self, batch: int, seq: int, dtype=torch.bfloat16):
        """{name: (shape, dtype)} of the cache tensors; on a mesh this
        rank's (:meth:`on_mesh`)."""
        cfg = self.cfg
        conv_dim, n_heads = self._dims()
        batch, seq = self._local_cache_dims(batch, seq)
        kv = (self.n_attn, batch, cfg.n_kv_heads, seq, cfg.hd)
        return {"k": (kv, dtype), "v": (kv, dtype),
                "conv": ((cfg.n_layers, batch, D_CONV - 1, conv_dim),
                         torch.float32),
                "ssm": ((cfg.n_layers, batch, n_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), torch.float32)}

    def init_cache(self, batch: int, seq: int, dtype=torch.bfloat16,
                   device=None):
        cache = {name: torch.zeros(shape, dtype=dt, device=device)
                 for name, (shape, dt) in
                 self.cache_spec(batch, seq, dtype).items()}
        return {**cache, "index": 0}

    def prefill(self, params, batch, cache_dtype=torch.bfloat16,
                cache_len=None):
        """Returns (last-token logits [B, V] f32, the state after the
        prompt, its K/V in ``cache_dtype`` and as long as the prompt, or
        ``cache_len`` positions, zeros past it).  On a mesh this rank's
        rows and cache, in the decode layout (:meth:`on_mesh`;
        ``cache_len`` must split over ``(pod, model)``)."""
        tokens = batch["tokens"]
        if self.place is not None:
            self._check_seq(cache_len or tokens.shape[1])
        h = self._embed(params, tokens)
        h, state = self._run(params, h, cache_dtype, cache_len)
        state = {**state, "index": tokens.shape[1]}
        if self.place is not None:
            state = self._decode_layout(state,
                                        self._global_rows(tokens.shape[0]))
        return self._head(params, h[:, -1]), state

    def decode_step(self, params, cache, tokens):
        """One token for every sequence.  tokens: [B] int.  Returns
        (logits [B, V] f32, cache with ``index + 1``)."""
        cfg = self.cfg
        index = cache["index"]
        h = self._embed(params, tokens[:, None])
        for g, (lo, hi) in enumerate(self.groups):
            h = self._shared_attn_step(params["shared_attn"], h,
                                       cache["k"][g], cache["v"][g], index)
            for li in range(lo, hi):
                lp = layer_params(params["layers"], li)
                a = L.apply_norm(lp["norm"], h, "rmsnorm")
                o, conv, ssm = apply_mamba2_step(
                    lp["mamba"], a[:, 0], cfg, cache["conv"][li],
                    cache["ssm"][li], self.mtp)
                cache["conv"][li] = conv
                cache["ssm"][li] = ssm
                h = h + o[:, None, :]
        h = L.apply_norm(params["final_norm"], h, "rmsnorm")
        return self._head(params, h[:, 0]), {**cache, "index": index + 1}
