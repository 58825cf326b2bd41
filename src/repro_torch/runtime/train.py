"""Training step factory (the port of ``repro.runtime.train``):
gradient accumulation over microbatches, global-norm clipping, AdamW,
and optional gradient compression with error feedback.

Gradients come from ``torch.autograd.grad`` on detached copies of the
params that require a gradient; they and their sum are f32.  The step
updates params and the optimizer state in place (the JAX step donates
both) and returns them.
"""
from __future__ import annotations

import torch

from repro_torch.optim import compression as comp
from repro_torch.optim.adamw import clip_by_global_norm, tree_leaves, tree_map


def _split(x, grad_accum: int):
    """Microbatches of ``x`` [B, ...] as the reference splits them: rows
    i, i + ga, i + 2 ga, ... form microbatch i (``reshape(b // ga, ga,
    ...)`` then ``moveaxis(1, 0)``), so each data shard keeps its rows."""
    b = x.shape[0]
    if b % grad_accum:
        raise ValueError(f"batch {b} is not a multiple of grad_accum "
                         f"{grad_accum}")
    return x.reshape(b // grad_accum, grad_accum, *x.shape[1:]).movedim(1, 0)


def make_train_step(model, opt_update, *, grad_accum: int = 1,
                    clip: float = 1.0, compression: str = "none",
                    gather_dtype=None):
    """Returns train_step(params, opt_state[, residuals], batch) ->
    (params, opt_state[, residuals], {"loss", "grad_norm"}).

    ``gather_dtype=torch.bfloat16`` casts float matrices to bf16 before
    the loss (the reference does it before its FSDP all-gather); the
    optimizer still updates the f32 master weights."""
    if compression not in ("none", "bf16", "int8"):
        raise ValueError(f"compression {compression!r}: none, bf16 or int8")

    def cast_for_compute(p):
        if gather_dtype is None:
            return p
        return tree_map(lambda x: x.to(gather_dtype)
                        if (x.dim() >= 2 and x.dtype == torch.float32)
                        else x, p)

    def value_and_grad(params, mb):
        leaves = tree_leaves(params)
        live = [x.detach().requires_grad_(True) for x in leaves]
        it = iter(live)
        p = tree_map(lambda _: next(it), params)
        loss, _ = model.loss(cast_for_compute(p), mb)
        grads = torch.autograd.grad(loss, live)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it).float(), params)

    def compute_grads(params, batch):
        if grad_accum == 1:
            return value_and_grad(params, batch)
        mbs = {k: _split(v, grad_accum) for k, v in batch.items()}
        grads = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                               device=x.device), params)
        lsum = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        for i in range(grad_accum):
            loss, g = value_and_grad(params, {k: v[i] for k, v in
                                              mbs.items()})
            tree_map(lambda a, b: a.add_(b), grads, g)
            lsum = lsum + loss
            del g
        inv = 1.0 / grad_accum
        tree_map(lambda a: a.mul_(inv), grads)
        return lsum * inv, grads

    if compression == "none":
        def train_step(params, opt_state, batch):
            loss, grads = compute_grads(params, batch)
            grads, gn = clip_by_global_norm(grads, clip)
            params, opt_state = opt_update(grads, opt_state, params)
            return params, opt_state, {"loss": loss, "grad_norm": gn}
        return train_step

    def train_step_c(params, opt_state, residuals, batch):
        loss, grads = compute_grads(params, batch)
        grads, residuals = comp.compress_grads(grads, residuals, compression)
        grads, gn = clip_by_global_norm(grads, clip)
        params, opt_state = opt_update(grads, opt_state, params)
        return params, opt_state, residuals, {"loss": loss, "grad_norm": gn}

    return train_step_c
