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

``on_mesh(mesh)`` gives the same model placed on a ``(pod, data,
model)`` mesh of ranks (:meth:`TransformerLM.on_mesh`): tensor
parallelism over ``model`` in the layer functions, the batch's rows over
``(pod, data)``, the decode cache's rows over ``data`` and its sequence
over ``(pod, model)`` (the D-Cache schedule).
"""
from __future__ import annotations

import copy
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch.models import layers as L

AUX_LOSS_COEF = 0.01
REMAT = ("none", "full", "dots")
MOE_IMPLS = ("dense", "shardmap")

#: The products without batch dims, as they reach the dispatcher: a 2-D
#: ``x @ W``, and a 3-D one, which ``matmul`` folds to one 2-D product
#: when the input needs a gradient or is contiguous.  ``bmm`` (the
#: attention's batched products) is not among them.
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, func, *args, **kwargs):
    """The selective-checkpoint policy of ``remat="dots"``, the reference's
    ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``: keep
    the output of every product in :data:`DOT_OPS` but those the layer
    code runs under ``layers.unsaved`` (the FFN's down product and the
    MoE experts' products, which the reference does not keep), recompute
    the rest (elementwise ops, norms, batched products, and whatever the
    flash and wkv ``autograd.Function``s compute)."""
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if func in DOT_OPS and L.saving()
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


def place_model(model, mesh):
    """A copy of ``model`` placed on ``mesh`` (a ``DeviceMesh`` of ``pod``,
    ``data`` and ``model``, any of them missing, over every rank of the
    group): ``place`` (its ``launch.mesh.MeshPlacement``), ``specs``
    (``runtime.sharding.param_specs`` of its params), ``tp`` (the
    ``model`` axis where it has more than one rank, else None), ``seq``
    (the decode cache's sequence axis, ``(pod, model)``, where it has more
    than one rank, else None), ``rows`` (the axis a batch's rows split
    over: ``fsdp`` until :meth:`MeshModel.with_rows` says otherwise) and,
    with ``tp``, the dims of the embedding table and the untied
    ``lm_head`` that split over it (``embed_split``, ``head_split``).
    Raises ``NotImplementedError`` where neither the vocabulary nor d
    splits."""
    from repro_torch.launch.mesh import MeshPlacement
    from repro_torch.runtime.sharding import param_specs

    cfg = model.cfg
    placed = copy.copy(model)
    placed.place = place = MeshPlacement(mesh)
    placed.specs = specs = param_specs(
        mesh, model.init(torch.Generator(), device="meta"))
    n = place.sizes["model"]
    placed.tp = place.model if n > 1 else None
    placed.seq = place.seq if place.seq.size > 1 else None
    placed.rows = place.fsdp
    placed.embed_split = placed.head_split = None
    if n > 1:
        tables = [("embed", "table")] + (
            [] if cfg.tie_embeddings else [("lm_head", "w")])
        split = [specs[a][b].index("model") if "model" in specs[a][b]
                 else None for a, b in tables]
        if None in split:
            raise NotImplementedError(
                f"{cfg.name} over model = {n}: neither the vocabulary "
                "nor d splits over the model axis")
        placed.embed_split, placed.head_split = split[0], split[-1]
    return placed


class MeshModel:
    """What a model placed on a mesh (:func:`place_model`) does with its
    rows and its decode cache, shared by the three families.

    The batch's rows split over ``rows`` (``MeshPlacement.rows_axis``:
    ``(pod, data)``, or ``pod`` alone where the batch does not divide);
    decode splits its rows over :meth:`decode_rows`, ``data`` (the
    reference's ``decode_token_spec``), so the pod ranks of one
    ``(data, model)`` coordinate hold the same rows, and the KV cache's
    sequence over ``seq``, ``(pod, model)``.  A prefill whose rows split
    over ``pod`` therefore ends in another layout than the one it
    computed: :meth:`_decode_layout` moves its cache there."""

    def with_rows(self, rows):
        """This placed model for a batch whose rows split over ``rows``
        (an axis of ``MeshPlacement.rows_axis``; ``None``: every rank
        holds every row)."""
        placed = copy.copy(self)
        placed.rows = rows
        return placed

    def decode_rows(self, batch: int):
        """The axis a decode batch of ``batch`` rows splits over: ``data``
        where it divides, else none (every rank every row)."""
        return self.place.rows_axis(batch, ("data",))

    def _global_rows(self, n: int) -> int:
        """The global batch of which this rank holds ``n`` rows."""
        return n * (1 if self.rows is None else self.rows.size)

    def _check_seq(self, seq: int) -> int:
        """This rank's positions of a cache of ``seq``; raises where they
        do not split over ``seq``."""
        n = 1 if self.seq is None else self.seq.size
        if seq % n:
            raise ValueError(
                f"a cache of {seq} positions does not split over "
                f"{self.seq.name} = {n}")
        return seq // n

    def _local_cache_dims(self, batch: int, seq: int):
        """(rows, positions) of this rank's decode cache of a global
        ``batch`` x ``seq``."""
        if self.place is None:
            return batch, seq
        rows = self.decode_rows(batch)
        return (batch if rows is None else batch // rows.size,
                self._check_seq(seq))

    def _moves(self) -> bool:
        """Whether the prefill's rows leave this rank before decode: they
        split over ``pod`` (decode's rows do not)."""
        return self.place.sizes["pod"] > 1 and self.rows is not None

    def _seq_extent(self, x, dim: int):
        """This rank's extent of ``x``'s positions along ``dim``: that of
        its ``seq`` index, or, where the rows move (:meth:`_moves`), the
        extents of every pod index at its ``model`` index, pod-major (the
        only ones a rank of its ``model`` index asks of it)."""
        if self.seq is None:
            return x
        if not self._moves():
            return self.seq.part(x, dim)
        pods, n = self.place.sizes["pod"], self.place.sizes["model"]
        x = x.unflatten(dim, (pods, n, x.shape[dim] // (pods * n)))
        return x.select(dim + 1, self.place.coord["model"]).flatten(
            dim, dim + 1)

    def _decode_layout(self, cache, batch: int, kv=("k", "v")):
        """The prefill's cache (``kv``'s sequences cut by
        :meth:`_seq_extent`, dim 3) in the decode layout: rows over
        :meth:`decode_rows`, ``kv``'s sequence over ``seq``.  Where the
        rows move, each tensor is all-gathered over ``rows`` (counted in
        the placement's ``stats`` as ``redistribute``), then this rank
        keeps its decode rows and, of ``kv``, its pod's extent."""
        dec = self.decode_rows(batch)
        moves = self._moves()
        if not moves and (self.rows is not None or dec is None):
            return cache
        out = dict(cache)
        pods, pod = self.place.sizes["pod"], self.place.coord["pod"]
        for name, x in cache.items():
            if not isinstance(x, torch.Tensor):
                continue
            if moves:
                x = self.rows.all_gather(x, 1, kind="redistribute")
            if dec is not None:
                x = dec.part(x, 1)
            if moves and name in kv:
                n = x.shape[3] // pods
                x = x.narrow(3, pod * n, n)
            out[name] = x.contiguous()
        return out

    def _gather_rows(self, x, batch: int):
        """``x`` [L, rows, ...] with every row of a decode batch of
        ``batch``."""
        dec = self.decode_rows(batch)
        return x if dec is None else dec.all_gather(x, 1)


def split_over(spec, dim: int) -> bool:
    """Whether ``spec`` (a leaf's, from ``param_specs``) splits ``dim``
    over the ``model`` axis."""
    return "model" in (spec[dim] if isinstance(spec[dim], tuple)
                       else (spec[dim],))


class TransformerLM(MeshModel):
    """The reference's constructor keywords, with its defaults.
    ``q_chunk`` is the query chunk of the reference's
    ``chunked_attention``, where the port runs the flash kernel (whose
    tiles are its own): kept, read nowhere.  ``unroll_inner`` is the
    unroll of the reference's inner ``lax.scan`` (an XLA compile option):
    kept, read nowhere.  ``compute_dtype`` defaults to f32 (the
    reference's bf16 default is not the port's: the parity tests run
    f32 on both sides)."""

    def __init__(self, cfg, compute_dtype=torch.float32, q_chunk: int = 1024,
                 remat: str = "full", loss_chunk: int = 256,
                 moe_no_drop: bool = False, unroll_inner: bool = False,
                 kv_quant: str = "none", moe_impl: str = "dense"):
        if remat not in REMAT:
            raise ValueError(f"remat {remat!r}: the port takes "
                             f"{', '.join(REMAT)}")
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl {moe_impl!r}: the port takes "
                             f"{', '.join(MOE_IMPLS)}")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.q_chunk = q_chunk
        self.remat = remat
        self.loss_chunk = loss_chunk
        self.moe_no_drop = moe_no_drop
        self.unroll = unroll_inner
        self.kv_quant = kv_quant
        self.moe_impl = moe_impl
        # the placement (on_mesh): none in one process
        self.place = self.tp = self.seq = self.rows = self.specs = None
        self.embed_split = self.head_split = None

    def on_mesh(self, mesh) -> "TransformerLM":
        """This model placed on ``mesh`` (a ``DeviceMesh`` of ``pod``,
        ``data`` and ``model``, any of them missing, over every rank of
        the group): a copy whose methods take this rank's params as
        ``runtime.sharding.param_specs`` places them over ``model``
        (tensor parallelism: this rank's heads and ffn columns, or its
        ``E / model`` experts; the embedding table by vocabulary or,
        where it does not divide, by d), already gathered over the FSDP
        axes (``runtime.train`` / ``runtime.serve`` gather the shards),
        and this rank's rows of a batch (over ``rows``, :class:`MeshModel`).
        ``loss`` is the mean over the valid tokens of every ``(pod,
        data)`` rank; ``forward``, ``prefill`` and ``decode_step`` give
        this rank's rows; the dense cache (``cache_spec``, ``init_cache``,
        ``prefill``'s) is this rank's decode rows (over ``data``) and its
        extent of the sequence (over ``(pod, model)``), every head.
        Raises ``NotImplementedError`` where the heads or a product do
        not split over ``model``."""
        cfg = self.cfg
        placed = place_model(self, mesh)
        n = placed.place.sizes["model"]
        if n > 1:
            layer = placed.specs["layers"]
            dims = {"wq": -1, "wk": -1, "wv": -1, "wo": -2}
            want = [("attn", w, d) for w, d in dims.items()] + [
                ("mlp", w, -1 if w != "w_down" else -2)
                for w in layer["mlp"]
                if w.startswith("w_") and not cfg.is_moe]
            bad = [f"{blk}/{w}" for blk, w, d in want
                   if layer[blk][w][d] != "model"]
            if cfg.n_heads % n or cfg.n_kv_heads % n or bad:
                raise NotImplementedError(
                    f"{cfg.name} over model = {n}: the heads "
                    f"({cfg.n_heads}/{cfg.n_kv_heads}) or the products "
                    f"{bad} do not split over the model axis")
        return placed

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
        if not cfg.is_moe:
            return L.apply_mlp(lp["mlp"], m, cfg.act, self.tp), None
        if self.moe_impl == "shardmap":
            return L.apply_moe_shardmap(lp["mlp"], m, cfg, no_drop,
                                        self.place)
        return L.apply_moe(lp["mlp"], m, cfg, no_drop=no_drop,
                           place=self.place, rows=self.rows)

    def _layer(self, h, lp):
        """One block: attention, then the FFN, each with its residual.
        Returns (h, k, v, aux or None)."""
        cfg = self.cfg
        a = L.apply_norm(lp["attn_norm"], h, cfg.norm)
        o, k, v = L.attention_block(lp["attn"], a, cfg, self.tp)
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
        return self._embed(params, batch["tokens"])

    def _embed(self, params, tokens):
        return L.embed_tokens(params["embed"], tokens, self.compute_dtype,
                              self.tp, self.embed_split)

    def _unembed(self, params, h):
        return L.unembed(params["embed"], params.get("lm_head"), h,
                         self.cfg.tie_embeddings, self.tp, self.head_split)

    def _backbone(self, params, h, cache_dtype=None, cache_len=None):
        """Every layer over positions 0..S-1 of the embedded input ``h``.
        Returns (hidden [B, S, d] before the final norm, per-layer k and
        v [B, Hkv, S, D] in ``cache_dtype`` (none without one; padded to
        ``cache_len`` positions where given, :meth:`_cache_kv`), the MoE
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
                ks.append(self._cache_kv(k, cache_dtype, cache_len))
                vs.append(self._cache_kv(v, cache_dtype, cache_len))
        return h, ks, vs, aux

    def _cache_kv(self, k, cache_dtype, cache_len):
        """A layer's k (or v) [B, S, Hkv, D] in the cache's layout [B,
        Hkv, cache_len, D], zeros past S.  Over a mesh ``k`` holds this
        rank's heads: they are gathered over ``model`` and this rank
        keeps its extent of the positions, every head
        (:meth:`MeshModel._seq_extent`)."""
        if self.tp is not None:
            k = self.tp.all_gather(k, 2)
        k = k.transpose(1, 2)
        if cache_len is not None and cache_len > k.shape[2]:
            k = F.pad(k, (0, 0, 0, cache_len - k.shape[2]))
        return self._seq_extent(k, 2).to(cache_dtype)

    def forward(self, params, batch):
        """Full logits for ``batch["tokens"]`` or ``batch["embeds"]``
        (small vocab / parity tests).  Returns (logits f32 [B, S, V], the
        MoE aux summed over layers; 0 without MoE)."""
        cfg = self.cfg
        h, _, _, aux = self._backbone(params, self._inputs_to_h(params,
                                                                 batch))
        h = L.apply_norm(params["final_norm"], h, cfg.norm)
        return self._unembed(params, h), aux

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
        return L.nll_sum(self._unembed(params, hh), ll)

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
        if self.place is not None:   # the mean over every (pod, data) rank
            nll = L.reduce_from_group(nll, self.place.fsdp)
            cnt = self.place.fsdp.all_reduce(cnt)
        return nll / torch.clamp(cnt, min=1.0)

    # -- dense serving ------------------------------------------------------
    #
    # The cache is {"k", "v": [n_layers, B, Hkv, S, D], "index": int}: the
    # number of positions written, a host int (the JAX package keeps a
    # device scalar).  With kv_quant="int8", "k"/"v" are int8 codes and
    # "k_scale"/"v_scale" [n_layers, B, Hkv, S] their f32 scales.
    # ``decode_step`` writes the cache tensors in place.

    def cache_spec(self, batch: int, seq: int, dtype=torch.bfloat16):
        """{name: (shape, dtype)} of the cache tensors; on a mesh this
        rank's: its decode rows of ``batch`` (all where they do not split
        over ``data``) and its ``seq / (pod x model)`` positions."""
        cfg = self.cfg
        batch, seq = self._local_cache_dims(batch, seq)
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.hd)
        if self.kv_quant == "int8":
            return {"k": (shape, torch.int8), "v": (shape, torch.int8),
                    "k_scale": (shape[:-1], torch.float32),
                    "v_scale": (shape[:-1], torch.float32)}
        return {"k": (shape, dtype), "v": (shape, dtype)}

    def gather_cache(self, cache, batch: int):
        """The whole cache of a global batch of ``batch`` rows (every row,
        every position) from this rank's, on every rank of a placed
        model."""
        out = dict(cache)
        for k, v in cache.items():
            if isinstance(v, torch.Tensor):
                if self.seq is not None:
                    v = self.seq.all_gather(v, 3)
                out[k] = self._gather_rows(v, batch)
        return out

    def init_cache(self, batch: int, seq: int, dtype=torch.bfloat16,
                   device=None):
        cache = {name: torch.zeros(shape, dtype=dt, device=device)
                 for name, (shape, dt) in
                 self.cache_spec(batch, seq, dtype).items()}
        return {**cache, "index": 0}

    def prefill(self, params, batch, cache_dtype=torch.bfloat16,
                cache_len=None):
        """Returns (last-token logits [B, V] f32, cache of the prompt's
        K/V in ``cache_dtype``, ``cache_len`` positions (default the
        prompt's; zeros past it)).  The cache is that one under
        kv_quant="int8" too, as in the reference (``layers.quantize_kv``
        of it is the int8 cache).  The MoE FFN drops tokens unless
        ``moe_no_drop``.  On a mesh: this rank's rows, and its extent of
        the cache in the decode layout (``cache_len`` must split over
        ``(pod, model)``; :meth:`MeshModel._decode_layout`)."""
        cfg = self.cfg
        h = self._inputs_to_h(params, batch)
        b, s = h.shape[:2]
        if self.place is not None:
            self._check_seq(cache_len or s)
        h, ks, vs, _ = self._backbone(params, h, cache_dtype, cache_len)
        h = L.apply_norm(params["final_norm"], h[:, -1:], cfg.norm)
        logits = self._unembed(params, h)[:, 0]
        cache = {"k": torch.stack(ks), "v": torch.stack(vs), "index": s}
        if self.place is not None:
            cache = self._decode_layout(cache, self._global_rows(b))
        return logits, cache

    def decode_step(self, params, cache, tokens):
        """One token for every sequence of the batch.  tokens: [B] int.
        Returns (logits [B, V] f32, cache with ``index + 1``).  The MoE
        FFN never drops here (``no_drop``, as in the reference)."""
        cfg = self.cfg
        index = cache["index"]
        h = self._embed(params, tokens[:, None])
        for li in range(cfg.n_layers):
            lp = layer_params(params["layers"], li)
            a = L.apply_norm(lp["attn_norm"], h, cfg.norm)
            if self.kv_quant == "int8":
                o = L.decode_attention_q8(
                    lp["attn"], a, cfg, cache["k"][li], cache["v"][li],
                    cache["k_scale"][li], cache["v_scale"][li], index,
                    self.tp, self.seq)[0]
            else:
                o = L.decode_attention(lp["attn"], a, cfg, cache["k"][li],
                                       cache["v"][li], index, self.tp,
                                       self.seq)[0]
            h = h + o
            m = L.apply_norm(lp["mlp_norm"], h, cfg.norm)
            h = h + self._ffn(lp, m, no_drop=True)[0]
        h = L.apply_norm(params["final_norm"], h, cfg.norm)
        logits = self._unembed(params, h)[:, 0]
        return logits, {**cache, "index": index + 1}
