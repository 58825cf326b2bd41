"""AdamW (the port of ``repro.optim.adamw``).

Params, gradients and the moments are nested dicts of tensors in the
stacked-layer layout, so a leaf is a whole stack of per-layer matrices
and each update is a few torch operations over it.  The JAX step is
functional and donates its params and state (``donate_argnums``); here
the update writes params, ``m`` and ``v`` in place, which keeps one copy
of each on the card, and returns them.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32, 0-d, on the params' device
    m: Any
    v: Any


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """Leaves of a nested dict in its key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` in place so that their global norm is at most
    ``max_norm``.  Returns (grads, the norm before clipping, f32)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale.to(g.dtype))
    return grads, gn


def adamw(lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1):
    """Returns (init_fn, update_fn).  Decoupled weight decay on matrices
    only (``p.ndim >= 2``, as the reference counts dims of its stacked
    leaves); bias correction from the incremented step."""

    def init_fn(params) -> AdamWState:
        device = tree_leaves(params)[0].device
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    @torch.no_grad()
    def update_fn(grads, state: AdamWState, params):
        step = state.step + 1
        lr_t = (lr(step) if callable(lr) else
                torch.tensor(lr, dtype=torch.float32, device=step.device))
        t = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)

        def upd(g, m, v, p):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
            if p.ndim >= 2:  # decoupled weight decay on matrices only
                delta.add_(weight_decay * p.float())
            delta.mul_(lr_t)
            if p.dtype == torch.float32:
                p.sub_(delta)
            else:
                p.copy_(p.float() - delta)
            return p

        tree_map(upd, grads, state.m, state.v, params)
        return params, AdamWState(step=step, m=state.m, v=state.v)

    return init_fn, update_fn
