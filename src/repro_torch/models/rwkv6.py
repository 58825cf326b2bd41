"""RWKV-6 "Finch": attention-free RNN with data-dependent decay
(arXiv:2404.05892), the port of ``repro.models.rwkv6``.

Params use the JAX package's stacked-layer layout (``time_mix`` and
``channel_mix`` leaves carry a leading ``n_layers`` dim; the ``lm_head``
is untied), so weights convert one to one (``models.convert``).  Prefill
and ``forward`` run the chunked wkv recurrence through the RWKV6
wkv-scan kernel (``kernels.ops.rwkv_scan``); decode is the O(1)
recurrent step ``wkv_step`` in plain torch, as the JAX package computes
it outside any kernel.  A Python loop over layers replaces ``lax.scan``.
``loss`` is the training objective, the reference's: cross-entropy over
the full logits, no aux term.  Under a gradient the scan goes through
``ops.rwkv_scan_with_grad`` (the forward kernel's states variant and the
backward kernel), and under ``remat="full"`` (or "dots", which is the
same here) each layer is recomputed in the backward pass, as the reference checkpoints its ``layer_fn``.

``on_mesh(mesh)`` places the model on a ``(pod, data, model)`` mesh:
the batch's rows over ``(pod, data)`` (decode's too), the weights as
``runtime.sharding.param_specs`` places them (FSDP over ``(pod,
data)``, gathered by ``runtime.train`` / ``runtime.serve``), and tensor
parallelism by heads over ``model``, where the placement and the
computation differ (:meth:`RWKV6LM.on_mesh`).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.ref import (wkv_chunk, wkv_ref,  # noqa: F401
                                     wkv_step)
from repro_torch.kernels.ref import wkv_chunked_ref as wkv_chunked
from repro_torch.models import layers as L
from repro_torch.models.transformer import (REMAT, MeshModel, _needs_grad,
                                            layer_params, unbind_layers)

LORA_R = 32
DECAY_LORA_R = 64

__all__ = ["RWKV6LM", "wkv_chunk", "wkv_chunked", "wkv_step", "wkv_ref"]


class RWKV6LM(MeshModel):
    """RWKV-6 LM.  ``remat`` is "none" or, for "full" and "dots" alike,
    each layer recomputed whole in the backward pass: the reference
    checkpoints its ``layer_fn`` with no policy for any value but
    "none", so "dots" means "full" here too.  The reference's other
    keywords, with its defaults: ``loss_chunk`` is unread in the
    reference too (its loss is the CE over the full logits) and
    ``unroll_inner`` is the unroll of its inner ``lax.scan`` (an XLA
    compile option): kept, read nowhere."""

    def __init__(self, cfg, compute_dtype=torch.float32, chunk: int = 32,
                 remat: str = "full", loss_chunk: int = 256,
                 unroll_inner: bool = False):
        if remat not in REMAT:
            raise ValueError(f"remat {remat!r}: the port takes "
                             f"{', '.join(REMAT)}")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.chunk = chunk
        self.remat = remat
        self.loss_chunk = loss_chunk
        self.unroll = unroll_inner
        self.n_heads = cfg.d_model // cfg.ssm_head_dim
        self.dk = cfg.ssm_head_dim
        # the placement (on_mesh): none in one process
        self.place = self.tp = self.seq = self.rows = self.specs = None
        self.embed_split = self.head_split = None
        self.split = {}

    # -- init ---------------------------------------------------------------

    def on_mesh(self, mesh):
        """This model placed on ``mesh`` (``transformer.place_model``):
        its methods take this rank's params, gathered over the FSDP axes,
        and its rows of a batch (``rows``, ``transformer.MeshModel``),
        decode's as prefill's, over ``(pod, data)`` (:meth:`decode_rows`:
        the states' rows where ``cache_spec_shardings`` puts them);
        ``loss`` is the mean over every ``(pod, data)`` rank's valid
        labels.  Over ``model`` each rank runs ``H / model`` heads:

          * ``wr``, ``wk``, ``wv``, ``wg`` by columns (its heads), ``wo``
            by rows, its output summed over the axis;
          * ``u``, ``ln_x`` and ``w0`` replicated, each rank slicing its
            heads;
          * the ddlerp LoRA: ``lora_a`` by columns, its product gathered
            (every rank needs the five d-wide mixes whole), ``lora_b``
            replicated;
          * the decay LoRA: ``wa`` by columns and ``wb`` by rows, the
            product summed over the axis, then this rank's heads' columns
            of ``logw``;
          * the channel mix: ``wk`` by columns and ``wv`` by rows (summed
            over the axis); ``wr`` by columns, its product gathered,
            since ``sigmoid(xr @ wr)`` scales the whole d-wide output;
          * the wkv kernels on this rank's heads.

        The decode state holds this rank's rows, the shift states whole
        (d wide: every rank's mixes need them) and the wkv state of its
        heads [L, B, H / model, dk, dk], not ``cache_spec_shardings``'
        split of the state's last dim (``dv``, no head split; ROADMAP
        §C).  ``gather_cache`` gives the whole state.  Raises
        ``NotImplementedError`` where the heads or a product do not
        split over ``model``."""
        from repro_torch.models.transformer import place_model, split_over

        cfg = self.cfg
        placed = place_model(self, mesh)
        n = placed.place.sizes["model"]
        placed.split = {}
        if n > 1:
            tm = placed.specs["layers"]["time_mix"]
            cm = placed.specs["layers"]["channel_mix"]
            bad = [f"time_mix/{w}" for w in ("wr", "wk", "wv", "wg")
                   if not split_over(tm[w], -1)]
            bad += [] if split_over(tm["wo"], -2) else ["time_mix/wo"]
            decay = split_over(tm["wa"], -1)
            if decay != split_over(tm["wb"], -2):
                bad += ["time_mix/wa", "time_mix/wb"]
            ffn = split_over(cm["wk"], -1)
            if ffn != split_over(cm["wv"], -2):
                bad += ["channel_mix/wk", "channel_mix/wv"]
            if self.n_heads % n or bad:
                raise NotImplementedError(
                    f"{cfg.name} over model = {n}: the heads "
                    f"({self.n_heads}) or the products {bad} do not split "
                    "over the model axis")
            placed.split = {"lora_a": split_over(tm["lora_a"], -1),
                            "decay": decay, "ffn": ffn,
                            "cm_wr": split_over(cm["wr"], -1)}
        return placed

    def decode_rows(self, batch: int):
        """The axis a decode batch's rows split over: prefill's, ``(pod,
        data)`` (``pod`` alone where they do not divide), as
        ``cache_spec_shardings`` places the states' rows (no K/V holds
        them to ``data``)."""
        return self.place.rows_axis(batch)

    def gather_cache(self, cache, batch: int):
        """The whole decode state of a global batch of ``batch`` rows
        (every row, every head) from this rank's, on every rank of a
        placed model."""
        out = dict(cache)
        if self.tp is not None:
            out["wkv"] = self.tp.all_gather(cache["wkv"], 2)
        for k in ("shift_tm", "shift_cm", "wkv"):
            out[k] = self._gather_rows(out[k], batch)
        return out

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> Dict[str, Any]:
        """Random params on ``device``, drawn from ``generator`` (a
        ``torch.Generator`` on that device).  Same shapes, layout and
        init distributions as the JAX ``RWKV6LM.init``; the numbers
        differ (different generators)."""
        cfg = self.cfg
        n, d, h, dk, f = (cfg.n_layers, cfg.d_model, self.n_heads, self.dk,
                          cfg.d_ff)
        kw = dict(dtype=dtype, device=device)

        def dense(shape):
            return L.dense_init(generator, shape, **kw)

        def zeros(*shape):
            return torch.zeros(shape, **kw)

        u = torch.empty((n, h, dk), device=device)
        u.normal_(0.0, 1.0, generator=generator)
        tm = {
            **{f"mu_{c}": zeros(n, d) for c in "xwkvrg"},
            "lora_a": dense((n, d, 5 * LORA_R)),
            "lora_b": zeros(n, 5, LORA_R, d),
            "w0": torch.full((n, d), -0.6, **kw),   # w ~ exp(-exp(-0.6)) ~ 0.58
            "wa": dense((n, d, DECAY_LORA_R)),
            "wb": zeros(n, DECAY_LORA_R, d),
            "u": (0.5 * u).to(dtype),
            **{name: dense((n, d, d)) for name in ("wr", "wk", "wv", "wg",
                                                     "wo")},
            "ln_x": torch.ones((n, h, dk), **kw),
        }
        cm = {"mu_k": zeros(n, d), "mu_r": zeros(n, d),
              "wk": dense((n, d, f)), "wv": dense((n, f, d)),
              "wr": dense((n, d, d))}
        return {
            "embed": {"table": L.embed_init(generator, (cfg.vocab_size, d),
                                            **kw)},
            "ln0": L.init_norm(d, "layernorm", **kw),
            "final_norm": L.init_norm(d, "layernorm", **kw),
            "layers": {"ln1": L.init_norm(d, "layernorm", lead=(n,), **kw),
                       "time_mix": tm,
                       "ln2": L.init_norm(d, "layernorm", lead=(n,), **kw),
                       "channel_mix": cm},
            "lm_head": {"w": dense((d, cfg.vocab_size))},
        }

    # -- time mix -----------------------------------------------------------

    def _ddlerp(self, tm, x, sx):
        """Data-dependent token-shift interpolation -> (xw, xk, xv, xr, xg)."""
        dx = sx - x
        xxx = x + dx * tm["mu_x"].to(x.dtype)
        lo = torch.tanh(L.col_full(xxx, tm["lora_a"], self.tp,
                                   self.split.get("lora_a", False)))
        lo = lo.reshape(*x.shape[:-1], 5, LORA_R)
        mix = torch.einsum("...ck,ckd->...cd", lo, tm["lora_b"].to(x.dtype))
        mus = torch.stack([tm[f"mu_{c}"] for c in "wkvrg"]).to(x.dtype)
        outs = x[..., None, :] + dx[..., None, :] * (mus + mix)
        return outs.unbind(-2)

    def _tm_proj(self, tm, x, sx):
        """(r, k, v, g, logw) of this rank's heads (every head in one
        process)."""
        xw, xk, xv, xr, xg = self._ddlerp(tm, x, sx)
        lead = x.shape[:-1]
        dk, tp = self.dk, self.tp
        if self.split.get("decay"):
            dec = L.reduce_from_group(torch.tanh(
                L.copy_to_group(xw, tp) @ tm["wa"].to(x.dtype)) @
                tm["wb"].to(x.dtype), tp)
        else:
            dec = torch.tanh(xw @ tm["wa"].to(x.dtype)) @ tm["wb"].to(x.dtype)
        w_dec = tm["w0"].float() + dec.float()
        logw = L.split_to_group(-torch.exp(w_dec), tp, -1)    # <= 0
        r, k, v, g = (L.copy_to_group(a, tp) @ tm[w].to(x.dtype)
                      for a, w in ((xr, "wr"), (xk, "wk"), (xv, "wv"),
                                   (xg, "wg")))
        # over a mesh logw is a slice of each row: the kernels take it
        # contiguous
        return (r.reshape(*lead, -1, dk), k.reshape(*lead, -1, dk),
                v.reshape(*lead, -1, dk), F.silu(g),
                logw.reshape(*lead, -1, dk).contiguous())

    def _heads(self, tm, name):
        """This rank's heads of a replicated [H, dk] leaf (``u``,
        ``ln_x``)."""
        return L.split_to_group(tm[name], self.tp, -2).contiguous()

    def _out(self, tm, o, g):
        """The group-normed heads' output through ``wo`` (its rows over a
        mesh, summed over ``model``)."""
        o = L.group_norm_heads(o, self._heads(tm, "ln_x"))
        o = o.reshape(g.shape) * g
        return L.reduce_from_group(o @ tm["wo"].to(o.dtype), self.tp)

    def _time_mix_seq(self, tm, x, shift_state, wkv_state):
        """x: [B, S, d].  Returns (out, last x, new wkv state)."""
        b, s, d = x.shape
        sx = torch.cat([shift_state[:, None, :], x[:, :-1]], dim=1)
        r, k, v, g, logw = self._tm_proj(tm, x, sx)
        args = (r.float(), k.float(), v.float(), logw,
                self._heads(tm, "u").float(), wkv_state)
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            o, s_t = ops.rwkv_scan_with_grad(*args, chunk=self.chunk)
        else:
            o, s_t = ops.rwkv_scan(*args, chunk=self.chunk)
        return self._out(tm, o.to(x.dtype), g), x[:, -1], s_t

    def _channel_mix_seq(self, cm, x, shift_state):
        sx = torch.cat([shift_state[:, None, :], x[:, :-1]], dim=1)
        return self._channel_mix(cm, x, sx), x[:, -1]

    def _channel_mix(self, cm, x, sx):
        dx = sx - x
        xk = x + dx * cm["mu_k"].to(x.dtype)
        xr = x + dx * cm["mu_r"].to(x.dtype)
        tp = self.tp if self.split.get("ffn") else None
        kk = torch.square(torch.relu(L.copy_to_group(xk, tp) @
                                     cm["wk"].to(x.dtype)))
        kv = L.reduce_from_group(kk @ cm["wv"].to(x.dtype), tp)
        return torch.sigmoid(L.col_full(xr, cm["wr"], self.tp,
                                        self.split.get("cm_wr", False))) * kv

    # -- forward ------------------------------------------------------------
    #
    # The state is {"shift_tm", "shift_cm": [n_layers, B, d], "wkv":
    # [n_layers, B, H, dk, dk] f32, "index": int} (a host int; the JAX
    # package keeps a device scalar).

    def cache_spec(self, batch: int, seq: int, dtype=torch.bfloat16):
        """{name: (shape, dtype)} of the state tensors; O(1) in ``seq``.
        On a mesh this rank's: its rows (:meth:`decode_rows`), the shift
        states whole, the wkv state of its heads."""
        del seq
        if self.place is not None:
            rows = self.decode_rows(batch)
            batch //= 1 if rows is None else rows.size
        return self._state_spec(batch, dtype)

    def _state_spec(self, rows: int, dtype):
        cfg = self.cfg
        heads = self.n_heads // (1 if self.place is None else
                                 self.place.sizes["model"])
        shift = (cfg.n_layers, rows, cfg.d_model)
        return {"shift_tm": (shift, dtype), "shift_cm": (shift, dtype),
                "wkv": ((cfg.n_layers, rows, heads, self.dk, self.dk),
                        torch.float32)}

    def init_cache(self, batch: int, seq: int, dtype=torch.bfloat16,
                   device=None):
        cache = {name: torch.zeros(shape, dtype=dt, device=device)
                 for name, (shape, dt) in
                 self.cache_spec(batch, seq, dtype).items()}
        return {**cache, "index": 0}

    def _layer(self, h, lp, st_tm, st_cm, wkv):
        """One layer (the reference's ``layer_fn``).  Returns (h, the
        time-mix and channel-mix shift states, the wkv state)."""
        a = L.apply_norm(lp["ln1"], h, "layernorm")
        o, n_tm, n_wkv = self._time_mix_seq(lp["time_mix"], a, st_tm, wkv)
        h = h + o
        c = L.apply_norm(lp["ln2"], h, "layernorm")
        o2, n_cm = self._channel_mix_seq(lp["channel_mix"], c, st_cm)
        return h + o2, n_tm, n_cm, n_wkv

    def backbone(self, params, h, state):
        """Every layer from ``state``.  When the params need a gradient
        the layers come from ``unbind_layers``, each recomputed in the
        backward pass unless ``remat="none"``."""
        n = self.cfg.n_layers
        train = torch.is_grad_enabled() and _needs_grad(params["layers"])
        layers = (unbind_layers(params["layers"], n) if train else
                  [layer_params(params["layers"], li) for li in range(n)])
        shift_tm, shift_cm, wkv = [], [], []
        for li, lp in enumerate(layers):
            args = (h, lp, state["shift_tm"][li].to(h.dtype),
                    state["shift_cm"][li].to(h.dtype), state["wkv"][li])
            if train and self.remat != "none":
                h, n_tm, n_cm, n_wkv = checkpoint(self._layer, *args,
                                                  use_reentrant=False)
            else:
                h, n_tm, n_cm, n_wkv = self._layer(*args)
            shift_tm.append(n_tm)
            shift_cm.append(n_cm)
            wkv.append(n_wkv)
        new_state = {
            "shift_tm": torch.stack(shift_tm).to(state["shift_tm"].dtype),
            "shift_cm": torch.stack(shift_cm).to(state["shift_cm"].dtype),
            "wkv": torch.stack(wkv), "index": state["index"] + h.shape[1]}
        return L.apply_norm(params["final_norm"], h, "layernorm"), new_state

    def _tokens(self, params, tokens):
        return L.embed_tokens(params["embed"], tokens, self.compute_dtype,
                              self.tp, self.embed_split)

    def _embed(self, params, batch):
        if "embeds" in batch:
            h = batch["embeds"].to(self.compute_dtype)
        else:
            h = self._tokens(params, batch["tokens"])
        return L.apply_norm(params["ln0"], h, "layernorm")

    def _head(self, params, h):
        return L.unembed(None, params["lm_head"], h, False, self.tp,
                         self.head_split)

    def _state0(self, h):
        """The zero state of ``h``'s rows (this rank's heads)."""
        spec = self._state_spec(h.shape[0], self.compute_dtype)
        return {**{name: torch.zeros(shape, dtype=dt, device=h.device)
                   for name, (shape, dt) in spec.items()}, "index": 0}

    def forward(self, params, batch):
        """Full logits (small vocab / parity tests).  Returns (logits f32
        [B, S, V], aux = 0)."""
        h = self._embed(params, batch)
        h, _ = self.backbone(params, h, self._state0(h))
        return self._head(params, h), torch.zeros((), device=h.device)

    def loss(self, params, batch):
        """(ce, {"ce", "aux": 0}) for ``batch["tokens"]`` (or
        ``batch["embeds"]``) and ``batch["labels"]`` [B, S] (label -1:
        not counted), as the reference's ``loss``; on a mesh the mean over
        every data rank's labels."""
        logits, _ = self.forward(params, batch)
        ce = L.cross_entropy(logits, batch["labels"], data=self.place and
                             self.place.fsdp)
        return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}

    # -- serving ------------------------------------------------------------

    def prefill(self, params, batch, cache_dtype=torch.bfloat16,
                cache_len=None):
        """Returns (last-token logits [B, V] f32, state with the shift
        states in ``cache_dtype``); ``cache_len`` is ignored (the state
        is O(1) in the sequence).  On a mesh this rank's rows and heads of
        the state."""
        del cache_len
        h = self._embed(params, batch)
        h, state = self.backbone(params, h, self._state0(h))
        state["shift_tm"] = state["shift_tm"].to(cache_dtype)
        state["shift_cm"] = state["shift_cm"].to(cache_dtype)
        return self._head(params, h[:, -1]), state

    def decode_step(self, params, cache, tokens):
        """tokens: [B].  O(1) per token: no state grows."""
        h = self._tokens(params, tokens)
        h = L.apply_norm(params["ln0"], h, "layernorm")          # [B, d]
        shift_tm, shift_cm, wkv = [], [], []
        for li in range(self.cfg.n_layers):
            lp = layer_params(params["layers"], li)
            tm, cm = lp["time_mix"], lp["channel_mix"]
            st_tm, st_cm = cache["shift_tm"][li], cache["shift_cm"][li]
            a = L.apply_norm(lp["ln1"], h, "layernorm")
            r, k, v, g, logw = self._tm_proj(tm, a, st_tm.to(a.dtype))
            o, n_wkv = wkv_step(r.float(), k.float(), v.float(), logw,
                                self._heads(tm, "u").float(),
                                cache["wkv"][li])
            h = h + self._out(tm, o.to(a.dtype), g)
            c = L.apply_norm(lp["ln2"], h, "layernorm")
            h = h + self._channel_mix(cm, c, st_cm.to(c.dtype))
            shift_tm.append(a.to(st_tm.dtype))
            shift_cm.append(c.to(st_cm.dtype))
            wkv.append(n_wkv)
        h = L.apply_norm(params["final_norm"], h, "layernorm")
        return self._head(params, h), {
            "shift_tm": torch.stack(shift_tm),
            "shift_cm": torch.stack(shift_cm), "wkv": torch.stack(wkv),
            "index": cache["index"] + 1}
