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
backward kernel), and under ``remat="full"`` each layer is recomputed in
the backward pass, as the reference checkpoints its ``layer_fn``.
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
from repro_torch.models.transformer import (REMAT, _needs_grad, layer_params,
                                            unbind_layers)

LORA_R = 32
DECAY_LORA_R = 64

__all__ = ["RWKV6LM", "wkv_chunk", "wkv_chunked", "wkv_step", "wkv_ref"]


class RWKV6LM:
    def __init__(self, cfg, compute_dtype=torch.float32, chunk: int = 32,
                 remat: str = "full"):
        if remat not in REMAT:
            raise NotImplementedError(
                f"remat {remat!r}: not yet ported (the port takes "
                f"{', '.join(REMAT)})")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.chunk = chunk
        self.remat = remat
        self.n_heads = cfg.d_model // cfg.ssm_head_dim
        self.dk = cfg.ssm_head_dim

    # -- init ---------------------------------------------------------------

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
        lo = torch.tanh(xxx @ tm["lora_a"].to(x.dtype))
        lo = lo.reshape(*x.shape[:-1], 5, LORA_R)
        mix = torch.einsum("...ck,ckd->...cd", lo, tm["lora_b"].to(x.dtype))
        mus = torch.stack([tm[f"mu_{c}"] for c in "wkvrg"]).to(x.dtype)
        outs = x[..., None, :] + dx[..., None, :] * (mus + mix)
        return outs.unbind(-2)

    def _tm_proj(self, tm, x, sx):
        xw, xk, xv, xr, xg = self._ddlerp(tm, x, sx)
        lead = x.shape[:-1]
        h, dk = self.n_heads, self.dk
        w_dec = tm["w0"].float() + (
            torch.tanh(xw @ tm["wa"].to(x.dtype)) @ tm["wb"].to(x.dtype)
        ).float()
        logw = -torch.exp(w_dec)                               # [..., d] <= 0
        r = (xr @ tm["wr"].to(x.dtype)).reshape(*lead, h, dk)
        k = (xk @ tm["wk"].to(x.dtype)).reshape(*lead, h, dk)
        v = (xv @ tm["wv"].to(x.dtype)).reshape(*lead, h, dk)
        g = F.silu(xg @ tm["wg"].to(x.dtype))
        return r, k, v, g, logw.reshape(*lead, h, dk)

    def _time_mix_seq(self, tm, x, shift_state, wkv_state):
        """x: [B, S, d].  Returns (out, last x, new wkv state)."""
        b, s, d = x.shape
        sx = torch.cat([shift_state[:, None, :], x[:, :-1]], dim=1)
        r, k, v, g, logw = self._tm_proj(tm, x, sx)
        args = (r.float(), k.float(), v.float(), logw, tm["u"].float(),
                wkv_state)
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            o, s_t = ops.rwkv_scan_with_grad(*args, chunk=self.chunk)
        else:
            o, s_t = ops.rwkv_scan(*args, chunk=self.chunk)
        o = L.group_norm_heads(o.to(x.dtype), tm["ln_x"])
        out = (o.reshape(b, s, d) * g) @ tm["wo"].to(x.dtype)
        return out, x[:, -1], s_t

    def _channel_mix_seq(self, cm, x, shift_state):
        sx = torch.cat([shift_state[:, None, :], x[:, :-1]], dim=1)
        return self._channel_mix(cm, x, sx), x[:, -1]

    def _channel_mix(self, cm, x, sx):
        dx = sx - x
        xk = x + dx * cm["mu_k"].to(x.dtype)
        xr = x + dx * cm["mu_r"].to(x.dtype)
        kk = torch.square(torch.relu(xk @ cm["wk"].to(x.dtype)))
        return torch.sigmoid(xr @ cm["wr"].to(x.dtype)) * (
            kk @ cm["wv"].to(x.dtype))

    # -- forward ------------------------------------------------------------
    #
    # The state is {"shift_tm", "shift_cm": [n_layers, B, d], "wkv":
    # [n_layers, B, H, dk, dk] f32, "index": int} (a host int; the JAX
    # package keeps a device scalar).

    def cache_spec(self, batch: int, seq: int, dtype=torch.bfloat16):
        """{name: (shape, dtype)} of the state tensors; O(1) in ``seq``."""
        del seq
        cfg = self.cfg
        shift = (cfg.n_layers, batch, cfg.d_model)
        return {"shift_tm": (shift, dtype), "shift_cm": (shift, dtype),
                "wkv": ((cfg.n_layers, batch, self.n_heads, self.dk, self.dk),
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
        backward pass under ``remat="full"``."""
        n = self.cfg.n_layers
        train = torch.is_grad_enabled() and _needs_grad(params["layers"])
        layers = (unbind_layers(params["layers"], n) if train else
                  [layer_params(params["layers"], li) for li in range(n)])
        shift_tm, shift_cm, wkv = [], [], []
        for li, lp in enumerate(layers):
            args = (h, lp, state["shift_tm"][li].to(h.dtype),
                    state["shift_cm"][li].to(h.dtype), state["wkv"][li])
            if train and self.remat == "full":
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

    def _embed(self, params, batch):
        if "embeds" in batch:
            h = batch["embeds"].to(self.compute_dtype)
        else:
            h = L.embed_tokens(params["embed"], batch["tokens"],
                               self.compute_dtype)
        return L.apply_norm(params["ln0"], h, "layernorm")

    def _head(self, params, h):
        return (h @ params["lm_head"]["w"].to(h.dtype)).float()

    def forward(self, params, batch):
        """Full logits (small vocab / parity tests).  Returns (logits f32
        [B, S, V], aux = 0)."""
        h = self._embed(params, batch)
        state = self.init_cache(h.shape[0], 0, self.compute_dtype, h.device)
        h, _ = self.backbone(params, h, state)
        return self._head(params, h), torch.zeros((), device=h.device)

    def loss(self, params, batch):
        """(ce, {"ce", "aux": 0}) for ``batch["tokens"]`` (or
        ``batch["embeds"]``) and ``batch["labels"]`` [B, S] (label -1:
        not counted), as the reference's ``loss``."""
        logits, _ = self.forward(params, batch)
        ce = L.cross_entropy(logits, batch["labels"])
        return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}

    # -- serving ------------------------------------------------------------

    def prefill(self, params, batch, cache_dtype=torch.bfloat16):
        """Returns (last-token logits [B, V] f32, state with the shift
        states in ``cache_dtype``)."""
        h = self._embed(params, batch)
        state = self.init_cache(h.shape[0], 0, self.compute_dtype, h.device)
        h, state = self.backbone(params, h, state)
        state["shift_tm"] = state["shift_tm"].to(cache_dtype)
        state["shift_cm"] = state["shift_cm"].to(cache_dtype)
        return self._head(params, h[:, -1]), state

    def decode_step(self, params, cache, tokens):
        """tokens: [B].  O(1) per token: no state grows."""
        h = L.embed_tokens(params["embed"], tokens, self.compute_dtype)
        h = L.apply_norm(params["ln0"], h, "layernorm")          # [B, d]
        shift_tm, shift_cm, wkv = [], [], []
        for li in range(self.cfg.n_layers):
            lp = layer_params(params["layers"], li)
            tm, cm = lp["time_mix"], lp["channel_mix"]
            st_tm, st_cm = cache["shift_tm"][li], cache["shift_cm"][li]
            a = L.apply_norm(lp["ln1"], h, "layernorm")
            r, k, v, g, logw = self._tm_proj(tm, a, st_tm.to(a.dtype))
            o, n_wkv = wkv_step(r.float(), k.float(), v.float(), logw,
                                tm["u"].float(), cache["wkv"][li])
            o = L.group_norm_heads(o.to(a.dtype), tm["ln_x"])
            h = h + (o.reshape(h.shape) * g) @ tm["wo"].to(a.dtype)
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
