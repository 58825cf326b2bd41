"""Uniform model interface (the port of ``repro.models.api``).

``get_model(cfg, compute_dtype, **kw)`` returns a :class:`Model` over the
family class (``TransformerLM``, ``RWKV6LM`` or ``Zamba2LM``).  init / forward /
prefill / decode_step / cache_spec / init_cache and every other
attribute (``compute_dtype``, ``remat``, ...) read through to the family
class, so the serving code takes a :class:`Model` where it took the
class; the facade adds ``loss`` (every family has one: the transformer's
chunked CE with the MoE aux term, RWKV6's and Zamba2's CE over the full
logits, as the reference's), ``uses_embeds``, ``synth_batch`` and the
param counts.  Options the
family class does not take are dropped, as the reference's
``_filter_kwargs`` drops them.  The reference's
``input_specs`` (shape stand-ins for its XLA dry run) is not ported.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import frontends
from repro_torch.models.mamba2 import Zamba2LM
from repro_torch.models.rwkv6 import RWKV6LM
from repro_torch.models.transformer import TransformerLM


def _leaves(tree, path=()):
    """(key path, leaf) of every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield path, tree


class Model:
    """Thin uniform facade; ``impl`` is the family-specific class."""

    def __init__(self, cfg: ArchConfig, impl):
        self.cfg = cfg
        self.impl = impl

    def __getattr__(self, name):
        # only reached for names the facade does not define itself
        if name == "impl":
            raise AttributeError(name)
        return getattr(self.impl, name)

    def loss(self, params, batch):
        """(total, {"ce", "aux"}) of the family's training objective."""
        return self.impl.loss(params, batch)

    # ------------------------------------------------------------------
    def uses_embeds(self) -> bool:
        """Frontend archs feed precomputed embeddings for train/prefill."""
        return self.cfg.frontend in ("vision", "audio")

    def synth_batch(self, shape: ShapeConfig,
                    generator: torch.Generator | None = None,
                    device=None) -> Dict[str, Any]:
        """A synthetic batch for ``shape``, drawn from ``generator`` (a
        ``torch.Generator`` on ``device``; seed 0 on the CPU when none is
        given): train, tokens and labels; prefill, tokens; decode, one
        token a sequence and a zero cache.  A frontend arch gets the
        frontend's embeddings (``frontends.synth_embeddings``) in place
        of the train and prefill tokens."""
        if generator is None:
            generator = torch.Generator(device=device or "cpu").manual_seed(0)
        b, s = shape.global_batch, shape.seq_len
        toks = torch.randint(0, self.cfg.vocab_size, (b, s),
                             generator=generator, device=device)
        if shape.kind in ("train", "prefill") and self.uses_embeds():
            inputs = {"embeds": frontends.synth_embeddings(
                self.cfg, b, s, generator, device=device)}
        else:
            inputs = {"tokens": toks}
        if shape.kind == "train":
            return {**inputs, "labels": toks}
        if shape.kind == "prefill":
            return inputs
        return {"tokens": toks[:, 0],
                "cache": self.init_cache(b, s, device=device)}

    def param_count(self, params) -> int:
        return sum(x.numel() for _, x in _leaves(params))

    def active_param_count(self, params) -> int:
        """MoE-aware: only top_k / n_experts of the expert weights (an
        ``mlp`` leaf with n_experts at dim -3, or at dim 1 of a stacked
        one) count, each share rounded down as the reference's
        ``visit`` does."""
        cfg = self.cfg
        if not cfg.is_moe:
            return self.param_count(params)
        total = 0
        for path, x in _leaves(params):
            expert = "mlp" in path and (
                (x.dim() >= 3 and x.shape[-3] == cfg.n_experts) or
                (x.dim() >= 4 and x.shape[1] == cfg.n_experts))
            total += (int(x.numel() * cfg.top_k / cfg.n_experts) if expert
                      else x.numel())
        return total


def _filter_kwargs(cls, kw):
    sig = inspect.signature(cls.__init__)
    return {k: v for k, v in kw.items() if k in sig.parameters}


def get_model(cfg: ArchConfig, compute_dtype=torch.float32, **kw) -> Model:
    cls = {"rwkv6": RWKV6LM, "mamba2_hybrid": Zamba2LM}.get(
        cfg.block_type, TransformerLM)
    impl = cls(cfg, compute_dtype=compute_dtype, **_filter_kwargs(cls, kw))
    return Model(cfg, impl)
