"""Uniform model interface (the port of ``repro.models.api``).

``get_model(cfg, compute_dtype, **kw)`` returns a :class:`Model` over the
family class (``TransformerLM`` or ``RWKV6LM``).  init / forward /
prefill / decode_step / cache_spec / init_cache and every other
attribute (``compute_dtype``, ``remat``, ...) read through to the family
class, so the serving code takes a :class:`Model` where it took the
class; the facade adds ``loss`` (raising for a family without one),
``uses_embeds``, ``synth_batch`` and the param counts.  Options the
family class does not take are dropped, as the reference's
``_filter_kwargs`` drops them.  The reference's
``input_specs`` (shape stand-ins for its XLA dry run) is not ported.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.rwkv6 import RWKV6LM
from repro_torch.models.transformer import TransformerLM


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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
        if not hasattr(self.impl, "loss"):
            raise NotImplementedError(
                f"{type(self.impl).__name__}.loss: not yet ported")
        return self.impl.loss(params, batch)

    # ------------------------------------------------------------------
    def uses_embeds(self) -> bool:
        """Frontend archs feed precomputed embeddings for train/prefill."""
        return self.cfg.frontend in ("vision", "audio")

    def synth_batch(self, shape: ShapeConfig,
                    generator: torch.Generator | None = None,
                    device=None) -> Dict[str, Any]:
        """A synthetic batch of token ids for ``shape`` (train: tokens
        and labels; prefill: tokens; decode: one token a sequence and a
        zero cache).  Frontend embeddings are not ported."""
        if self.uses_embeds():
            raise NotImplementedError("frontend embeddings: not yet ported")
        if generator is None:
            generator = torch.Generator(device=device or "cpu").manual_seed(0)
        b, s = shape.global_batch, shape.seq_len
        toks = torch.randint(0, self.cfg.vocab_size, (b, s),
                             generator=generator, device=device)
        if shape.kind == "train":
            return {"tokens": toks, "labels": toks}
        if shape.kind == "prefill":
            return {"tokens": toks}
        return {"tokens": toks[:, 0],
                "cache": self.init_cache(b, s, device=device)}

    def param_count(self, params) -> int:
        return sum(x.numel() for x in _leaves(params))

    def active_param_count(self, params) -> int:
        """Every param is active: the port runs no MoE FFN yet."""
        if self.cfg.is_moe:
            raise NotImplementedError("MoE FFN: not yet ported")
        return self.param_count(params)


def _filter_kwargs(cls, kw):
    sig = inspect.signature(cls.__init__)
    return {k: v for k, v in kw.items() if k in sig.parameters}


def get_model(cfg: ArchConfig, compute_dtype=torch.float32, **kw) -> Model:
    if cfg.block_type == "rwkv6":
        cls = RWKV6LM
    elif cfg.block_type == "transformer":
        cls = TransformerLM
    else:
        raise NotImplementedError(
            f"block_type {cfg.block_type!r}: not yet ported")
    impl = cls(cfg, compute_dtype=compute_dtype, **_filter_kwargs(cls, kw))
    return Model(cfg, impl)
