"""Decoder-only transformer LM (dense FFN, GQA, RoPE, tied embeddings).

Params use the JAX package's stacked-layer layout: every leaf under
``params["layers"]`` carries a leading ``n_layers`` dim, so weights
convert one to one (``models.convert``).  The paged serving path
(``runtime.serve.PagedServer``) consumes the same params.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import layers as L


def layer_params(stacked, li: int):
    """Views of layer ``li`` of a stacked param tree (no copy)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, li) for k, v in stacked.items()}
    return stacked[li]


def causal_attention(q, k, v, positions):
    """Plain masked-softmax GQA attention in f32.  q: [B,S,H,D];
    k/v: [B,S,Hkv,D]; positions: [B,S].  Returns [B,S,H,D]."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.float().reshape(b, s, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(d)
    mask = positions[:, None, None, :, None] >= positions[:, None, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


class TransformerLM:
    def __init__(self, cfg, compute_dtype=torch.float32):
        if cfg.is_moe:
            raise NotImplementedError("MoE FFN: not yet ported")
        self.cfg = cfg
        self.compute_dtype = compute_dtype

    # -- init ---------------------------------------------------------------

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Dict[str, Any]:
        """Random params on ``device``, drawn from ``generator`` (a
        ``torch.Generator`` on that device).  Same shapes, layout and
        init distributions as the JAX ``TransformerLM.init``; the
        numbers differ (different generators)."""
        cfg = self.cfg
        n, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        kw = dict(dtype=dtype, device=device)

        def dense(shape, in_axis=-2):
            return L.dense_init(generator, shape, in_axis=in_axis, **kw)

        def norm():
            p = {"scale": torch.ones((n, d), **kw)}
            if cfg.norm == "layernorm":
                p["bias"] = torch.zeros((n, d), **kw)
            return p

        attn = {"wq": dense((n, d, h * hd)), "wk": dense((n, d, hkv * hd)),
                "wv": dense((n, d, hkv * hd)),
                "wo": dense((n, h * hd, d), in_axis=1)}
        if cfg.qkv_bias:
            attn["bq"] = torch.zeros((n, h * hd), **kw)
            attn["bk"] = torch.zeros((n, hkv * hd), **kw)
            attn["bv"] = torch.zeros((n, hkv * hd), **kw)
        if cfg.act == "gelu":
            mlp = {"w_up": dense((n, d, f)), "b_up": torch.zeros((n, f), **kw),
                   "w_down": dense((n, f, d)),
                   "b_down": torch.zeros((n, d), **kw)}
        else:
            mlp = {"w_gate": dense((n, d, f)), "w_up": dense((n, d, f)),
                   "w_down": dense((n, f, d))}
        final = {"scale": torch.ones((d,), **kw)}
        if cfg.norm == "layernorm":
            final["bias"] = torch.zeros((d,), **kw)
        params = {
            "embed": {"table": L.embed_init(generator, (cfg.vocab_size, d),
                                            **kw)},
            "final_norm": final,
            "layers": {"attn_norm": norm(), "attn": attn,
                       "mlp_norm": norm(), "mlp": mlp},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": dense((d, cfg.vocab_size))}
        return params

    # -- forward ------------------------------------------------------------

    def forward(self, params, batch):
        """Full logits for ``batch["tokens"]`` [B, S] (small vocab /
        parity tests).  Returns (logits f32 [B, S, V], aux = 0)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        h = L.embed_tokens(params["embed"], tokens, self.compute_dtype)
        b, s, _ = h.shape
        positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
        for li in range(cfg.n_layers):
            lp = layer_params(params["layers"], li)
            a = L.apply_norm(lp["attn_norm"], h, cfg.norm)
            q, k, v = L._qkv(lp["attn"], a, cfg)
            if cfg.rope:
                q = L.apply_rope(q, positions, cfg.rope_theta)
                k = L.apply_rope(k, positions, cfg.rope_theta)
            o = causal_attention(q, k, v, positions)
            h = h + o.reshape(b, s, -1) @ lp["attn"]["wo"].to(h.dtype)
            m = L.apply_norm(lp["mlp_norm"], h, cfg.norm)
            h = h + L.apply_mlp(lp["mlp"], m, cfg.act)
        h = L.apply_norm(params["final_norm"], h, cfg.norm)
        logits = L.unembed(params["embed"], params.get("lm_head"), h,
                           cfg.tie_embeddings)
        return logits, torch.zeros((), device=h.device)
