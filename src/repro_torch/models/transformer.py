"""Decoder-only transformer LM (dense FFN, GQA, RoPE, tied embeddings).

Params use the JAX package's stacked-layer layout: every leaf under
``params["layers"]`` carries a leading ``n_layers`` dim, so weights
convert one to one (``models.convert``).  ``forward`` and ``prefill``
attend through the flash-attention kernel (``layers.chunked_attention``);
``decode_step`` runs one token against the dense KV cache that
``prefill`` returns.  The paged serving path
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
    """Plain masked-softmax GQA attention in f32, the reference the
    tests hold ``layers.chunked_attention`` to.  q: [B,S,H,D];
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
            return L.init_norm(d, cfg.norm, lead=(n,), **kw)

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
        params = {
            "embed": {"table": L.embed_init(generator, (cfg.vocab_size, d),
                                            **kw)},
            "final_norm": L.init_norm(d, cfg.norm, **kw),
            "layers": {"attn_norm": norm(), "attn": attn,
                       "mlp_norm": norm(), "mlp": mlp},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": dense((d, cfg.vocab_size))}
        return params

    # -- forward ------------------------------------------------------------

    def _backbone(self, params, tokens, cache_dtype=None):
        """Embedding and every layer over positions 0..S-1.  Returns
        (hidden [B, S, d] before the final norm, per-layer k and v
        [B, Hkv, S, D] in ``cache_dtype``; none without one)."""
        cfg = self.cfg
        h = L.embed_tokens(params["embed"], tokens, self.compute_dtype)
        ks, vs = [], []
        for li in range(cfg.n_layers):
            lp = layer_params(params["layers"], li)
            a = L.apply_norm(lp["attn_norm"], h, cfg.norm)
            o, k, v = L.attention_block(lp["attn"], a, cfg)
            h = h + o
            m = L.apply_norm(lp["mlp_norm"], h, cfg.norm)
            h = h + L.apply_mlp(lp["mlp"], m, cfg.act)
            if cache_dtype is not None:
                ks.append(k.transpose(1, 2).to(cache_dtype))
                vs.append(v.transpose(1, 2).to(cache_dtype))
        return h, ks, vs

    def forward(self, params, batch):
        """Full logits for ``batch["tokens"]`` [B, S] (small vocab /
        parity tests).  Returns (logits f32 [B, S, V], aux = 0)."""
        cfg = self.cfg
        h, _, _ = self._backbone(params, batch["tokens"])
        h = L.apply_norm(params["final_norm"], h, cfg.norm)
        logits = L.unembed(params["embed"], params.get("lm_head"), h,
                           cfg.tie_embeddings)
        return logits, torch.zeros((), device=h.device)

    # -- dense serving ------------------------------------------------------
    #
    # The cache is {"k", "v": [n_layers, B, Hkv, S, D], "index": int}: the
    # number of positions written, a host int (the JAX package keeps a
    # device scalar).  ``decode_step`` writes the cache tensors in place.

    def cache_spec(self, batch: int, seq: int, dtype=torch.bfloat16):
        """{name: (shape, dtype)} of the cache tensors."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.hd)
        return {"k": (shape, dtype), "v": (shape, dtype)}

    def init_cache(self, batch: int, seq: int, dtype=torch.bfloat16,
                   device=None):
        cache = {name: torch.zeros(shape, dtype=dt, device=device)
                 for name, (shape, dt) in
                 self.cache_spec(batch, seq, dtype).items()}
        return {**cache, "index": 0}

    def prefill(self, params, batch, cache_dtype=torch.bfloat16):
        """Returns (last-token logits [B, V] f32, cache of the prompt's
        K/V in ``cache_dtype``)."""
        cfg = self.cfg
        h, ks, vs = self._backbone(params, batch["tokens"], cache_dtype)
        h = L.apply_norm(params["final_norm"], h[:, -1:], cfg.norm)
        logits = L.unembed(params["embed"], params.get("lm_head"), h,
                           cfg.tie_embeddings)[:, 0]
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                        "index": batch["tokens"].shape[1]}

    def decode_step(self, params, cache, tokens):
        """One token for every sequence of the batch.  tokens: [B] int.
        Returns (logits [B, V] f32, cache with ``index + 1``)."""
        cfg = self.cfg
        index = cache["index"]
        h = L.embed_tokens(params["embed"], tokens[:, None],
                           self.compute_dtype)
        for li in range(cfg.n_layers):
            lp = layer_params(params["layers"], li)
            a = L.apply_norm(lp["attn_norm"], h, cfg.norm)
            o, _, _ = L.decode_attention(lp["attn"], a, cfg, cache["k"][li],
                                         cache["v"][li], index)
            h = h + o
            m = L.apply_norm(lp["mlp_norm"], h, cfg.norm)
            h = h + L.apply_mlp(lp["mlp"], m, cfg.act)
        h = L.apply_norm(params["final_norm"], h, cfg.norm)
        logits = L.unembed(params["embed"], params.get("lm_head"), h,
                           cfg.tie_embeddings)[:, 0]
        return logits, {**cache, "index": index + 1}
