"""Decoder-only (and encoder-only) transformer LM: dense or MoE FFN,
GQA / MQA / MHA, RoPE, tied embeddings, QKV bias.

Params use the JAX package's stacked-layer layout: every leaf under
``params["layers"]`` carries a leading ``n_layers`` dim, so weights
convert one to one (``models.convert``).  ``forward``, ``prefill`` and
``loss`` take token ids (``batch["tokens"]``) or a frontend's
precomputed embeddings (``batch["embeds"]``) and attend through the
flash-attention kernel (``layers.chunked_attention``); ``decode_step``
runs one token against the dense KV cache, f32/bf16 or, with
``kv_quant="int8"``, int8 codes with per-token scales.  The paged
serving path (``runtime.serve.PagedServer``) consumes the same params.
``loss`` is the training objective: seq-chunked cross-entropy, so the
[B, S, V] logits are never materialised, plus ``AUX_LOSS_COEF`` times
the MoE load-balancing term, with each layer recomputed in the backward
pass under ``remat="full"``, or everything but its matrix products
without batch dims under ``remat="dots"`` (:func:`remat_call`).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch.models import layers as L

AUX_LOSS_COEF = 0.01
REMAT = ("none", "full", "dots")

#: The products without batch dims, as they reach the dispatcher: a 2-D
#: ``x @ W``, and a 3-D one, which ``matmul`` folds to one 2-D product
#: when the input needs a gradient or is contiguous.  ``bmm`` (the
#: attention's batched products) is not among them.
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, func, *args, **kwargs):
    """The selective-checkpoint policy of ``remat="dots"``, the reference's
    ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``: keep
    the output of every product in :data:`DOT_OPS`, recompute the rest
    (elementwise ops, norms, batched products, and whatever the flash and
    wkv ``autograd.Function``s compute)."""
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if func in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(dots_policy)


def remat_call(remat: str, fn, *args):
    """``fn(*args)`` under the remat policy: as is (``"none"``),
    recomputed whole in the backward pass (``"full"``), or recomputed but
    for the products :func:`dots_policy` keeps (``"dots"``)."""
    if remat == "none":
        return fn(*args)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_dots_context)
    return checkpoint(fn, *args, use_reentrant=False)


def layer_params(stacked, li: int):
    """Views of layer ``li`` of a stacked param tree (no copy)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, li) for k, v in stacked.items()}
    return stacked[li]


def unbind_layers(stacked, n_layers: int):
    """The ``n_layers`` per-layer trees of a stacked tree, from one
    ``unbind(0)`` a leaf.  Under autograd this is the training route:
    one ``UnbindBackward`` stacks a leaf's per-layer gradients, where
    ``stacked[li]`` per layer would add one zero-filled, stack-sized
    gradient a layer."""
    if isinstance(stacked, dict):
        per = {k: unbind_layers(v, n_layers) for k, v in stacked.items()}
        return [{k: per[k][li] for k in per} for li in range(n_layers)]
    return stacked.unbind(0)


def _needs_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_needs_grad(v) for v in tree.values())
    return tree.requires_grad


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
    def __init__(self, cfg, compute_dtype=torch.float32, remat: str = "full",
                 loss_chunk: int = 256, moe_no_drop: bool = False,
                 kv_quant: str = "none"):
        if remat not in REMAT:
            raise ValueError(f"remat {remat!r}: the port takes "
                             f"{', '.join(REMAT)}")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.loss_chunk = loss_chunk
        self.moe_no_drop = moe_no_drop
        self.kv_quant = kv_quant

    # -- init ---------------------------------------------------------------

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Dict[str, Any]:
        """Random params on ``device``, drawn from ``generator`` (a
        ``torch.Generator`` on that device).  Same shapes, layout and
        init distributions as the JAX ``TransformerLM.init``; the
        numbers differ (different generators)."""
        cfg = self.cfg
        n, d = cfg.n_layers, cfg.d_model
        kw = dict(dtype=dtype, device=device)

        def norm():
            return L.init_norm(d, cfg.norm, lead=(n,), **kw)

        attn = L.init_attention(generator, cfg, lead=(n,), **kw)
        mlp = (L.init_moe if cfg.is_moe else L.init_mlp)(
            generator, cfg, lead=(n,), **kw)
        params = {
            "embed": {"table": L.embed_init(generator, (cfg.vocab_size, d),
                                            **kw)},
            "final_norm": L.init_norm(d, cfg.norm, **kw),
            "layers": {"attn_norm": norm(), "attn": attn,
                       "mlp_norm": norm(), "mlp": mlp},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": L.dense_init(
                generator, (d, cfg.vocab_size), **kw)}
        return params

    # -- forward ------------------------------------------------------------

    def _ffn(self, lp, m, no_drop: bool):
        """The FFN half on the normed ``m``: (out, the MoE aux; None for
        a dense MLP)."""
        cfg = self.cfg
        if cfg.is_moe:
            return L.apply_moe(lp["mlp"], m, cfg, no_drop=no_drop)
        return L.apply_mlp(lp["mlp"], m, cfg.act), None

    def _layer(self, h, lp):
        """One block: attention, then the FFN, each with its residual.
        Returns (h, k, v, aux or None)."""
        cfg = self.cfg
        a = L.apply_norm(lp["attn_norm"], h, cfg.norm)
        o, k, v = L.attention_block(lp["attn"], a, cfg)
        h = h + o
        m = L.apply_norm(lp["mlp_norm"], h, cfg.norm)
        mo, aux = self._ffn(lp, m, self.moe_no_drop)
        return h + mo, k, v, aux

    def _train_layer(self, h, lp):
        h, _, _, aux = self._layer(h, lp)
        return h, aux

    def _inputs_to_h(self, params, batch):
        """The frontend's embeddings ``batch["embeds"]`` [B, S, d] where
        given, else the embedding of ``batch["tokens"]`` [B, S]."""
        if "embeds" in batch:
            return batch["embeds"].to(self.compute_dtype)
        return L.embed_tokens(params["embed"], batch["tokens"],
                              self.compute_dtype)

    def _backbone(self, params, h, cache_dtype=None):
        """Every layer over positions 0..S-1 of the embedded input ``h``.
        Returns (hidden [B, S, d] before the final norm, per-layer k and
        v [B, Hkv, S, D] in ``cache_dtype`` (none without one), the MoE
        aux summed over layers).  When the params need a gradient the
        layers come from ``unbind_layers``, each under the remat policy
        (:func:`remat_call`)."""
        cfg = self.cfg
        ks, vs = [], []
        aux = torch.zeros((), device=h.device)
        if torch.is_grad_enabled() and _needs_grad(params["layers"]):
            for lp in unbind_layers(params["layers"], cfg.n_layers):
                h, a = remat_call(self.remat, self._train_layer, h, lp)
                if a is not None:
                    aux = aux + a
            return h, ks, vs, aux
        for li in range(cfg.n_layers):
            h, k, v, a = self._layer(h, layer_params(params["layers"], li))
            if a is not None:
                aux = aux + a
            if cache_dtype is not None:
                ks.append(k.transpose(1, 2).to(cache_dtype))
                vs.append(v.transpose(1, 2).to(cache_dtype))
        return h, ks, vs, aux

    def forward(self, params, batch):
        """Full logits for ``batch["tokens"]`` or ``batch["embeds"]``
        (small vocab / parity tests).  Returns (logits f32 [B, S, V], the
        MoE aux summed over layers; 0 without MoE)."""
        cfg = self.cfg
        h, _, _, aux = self._backbone(params, self._inputs_to_h(params,
                                                                 batch))
        h = L.apply_norm(params["final_norm"], h, cfg.norm)
        logits = L.unembed(params["embed"], params.get("lm_head"), h,
                           cfg.tie_embeddings)
        return logits, aux

    # -- training loss -------------------------------------------------------

    def loss(self, params, batch):
        """(total, {"ce", "aux"}) for ``batch["tokens"]`` (or
        ``batch["embeds"]``) and ``batch["labels"]`` [B, S] (label -1:
        not counted): total = ce + AUX_LOSS_COEF * aux."""
        cfg = self.cfg
        h, _, _, aux = self._backbone(params, self._inputs_to_h(params,
                                                                 batch))
        h = L.apply_norm(params["final_norm"], h, cfg.norm)
        ce = self._chunked_ce(params, h, batch["labels"])
        return ce + AUX_LOSS_COEF * aux, {"ce": ce, "aux": aux}

    def _ce_chunk(self, params, hh, ll):
        """(sum of the chunk's NLL over counted labels, their count)."""
        return L.nll_sum(L.unembed(params["embed"], params.get("lm_head"),
                                   hh, self.cfg.tie_embeddings), ll)

    def _chunked_ce(self, params, h, labels):
        """Seq-chunked CE: logits materialised one chunk at a time (each
        chunk under the remat policy, as the reference's ``_maybe_remat``
        of its chunk), the sums carried in chunk order as the
        reference's scan does."""
        b, s, _ = h.shape
        ck = min(self.loss_chunk, s)
        n = s // ck
        if s % ck:
            n, ck = 1, s
        nll = torch.zeros((), device=h.device)
        cnt = torch.zeros((), device=h.device)
        remat = self.remat if torch.is_grad_enabled() else "none"
        for i in range(n):
            hh, ll = h[:, i * ck:(i + 1) * ck], labels[:, i * ck:(i + 1) * ck]
            part, c = remat_call(remat, self._ce_chunk, params, hh, ll)
            nll, cnt = nll + part, cnt + c
        return nll / torch.clamp(cnt, min=1.0)

    # -- dense serving ------------------------------------------------------
    #
    # The cache is {"k", "v": [n_layers, B, Hkv, S, D], "index": int}: the
    # number of positions written, a host int (the JAX package keeps a
    # device scalar).  With kv_quant="int8", "k"/"v" are int8 codes and
    # "k_scale"/"v_scale" [n_layers, B, Hkv, S] their f32 scales.
    # ``decode_step`` writes the cache tensors in place.

    def cache_spec(self, batch: int, seq: int, dtype=torch.bfloat16):
        """{name: (shape, dtype)} of the cache tensors."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.hd)
        if self.kv_quant == "int8":
            return {"k": (shape, torch.int8), "v": (shape, torch.int8),
                    "k_scale": (shape[:-1], torch.float32),
                    "v_scale": (shape[:-1], torch.float32)}
        return {"k": (shape, dtype), "v": (shape, dtype)}

    def init_cache(self, batch: int, seq: int, dtype=torch.bfloat16,
                   device=None):
        cache = {name: torch.zeros(shape, dtype=dt, device=device)
                 for name, (shape, dt) in
                 self.cache_spec(batch, seq, dtype).items()}
        return {**cache, "index": 0}

    def prefill(self, params, batch, cache_dtype=torch.bfloat16):
        """Returns (last-token logits [B, V] f32, cache of the prompt's
        K/V in ``cache_dtype``).  The cache is that one under
        kv_quant="int8" too, as in the reference (``layers.quantize_kv``
        of it is the int8 cache).  The MoE FFN drops tokens unless
        ``moe_no_drop``."""
        cfg = self.cfg
        h = self._inputs_to_h(params, batch)
        s = h.shape[1]
        h, ks, vs, _ = self._backbone(params, h, cache_dtype)
        h = L.apply_norm(params["final_norm"], h[:, -1:], cfg.norm)
        logits = L.unembed(params["embed"], params.get("lm_head"), h,
                           cfg.tie_embeddings)[:, 0]
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                        "index": s}

    def decode_step(self, params, cache, tokens):
        """One token for every sequence of the batch.  tokens: [B] int.
        Returns (logits [B, V] f32, cache with ``index + 1``).  The MoE
        FFN never drops here (``no_drop``, as in the reference)."""
        cfg = self.cfg
        index = cache["index"]
        h = L.embed_tokens(params["embed"], tokens[:, None],
                           self.compute_dtype)
        for li in range(cfg.n_layers):
            lp = layer_params(params["layers"], li)
            a = L.apply_norm(lp["attn_norm"], h, cfg.norm)
            if self.kv_quant == "int8":
                o = L.decode_attention_q8(
                    lp["attn"], a, cfg, cache["k"][li], cache["v"][li],
                    cache["k_scale"][li], cache["v_scale"][li], index)[0]
            else:
                o = L.decode_attention(lp["attn"], a, cfg, cache["k"][li],
                                       cache["v"][li], index)[0]
            h = h + o
            m = L.apply_norm(lp["mlp_norm"], h, cfg.norm)
            h = h + self._ffn(lp, m, no_drop=True)[0]
        h = L.apply_norm(params["final_norm"], h, cfg.norm)
        logits = L.unembed(params["embed"], params.get("lm_head"), h,
                           cfg.tie_embeddings)[:, 0]
        return logits, {**cache, "index": index + 1}
