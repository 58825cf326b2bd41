"""Training step factory (the port of ``repro.runtime.train``):
gradient accumulation over microbatches, global-norm clipping, AdamW,
and optional gradient compression with error feedback.

Gradients come from ``torch.autograd.grad`` on detached copies of the
params that require a gradient; they and their sum are f32.  The step
updates params and the optimizer state in place (the JAX step donates
both) and returns them.

Over a mesh (``make_train_step(..., mesh=)``) the step runs on each rank
of a ``(data, model)`` mesh: params, the AdamW moments and the
compression residuals are this rank's shards (``runtime.sharding.
shard_tree`` under ``param_specs``), the batch is the global one and
each rank takes its rows.  Leaves split over ``data`` (ZeRO-3 / FSDP)
are all-gathered before the loss and their gradients reduce-scattered
(the gather's backward, which is also the data-parallel reduction);
leaves replicated over ``data`` have their gradients all-reduced.  The
loss is the mean over every data rank's valid tokens, the clip's norm
counts each element once, int8 compression takes each row's max over
the row's shards, and AdamW updates each shard in place.
"""
from __future__ import annotations

import torch

from repro_torch.optim import compression as comp
from repro_torch.optim.adamw import clip_by_global_norm, tree_leaves, tree_map
from repro_torch.runtime.sharding import spec_axes


def _split(x, grad_accum: int):
    """Microbatches of ``x`` [B, ...] as the reference splits them: rows
    i, i + ga, i + 2 ga, ... form microbatch i (``reshape(b // ga, ga,
    ...)`` then ``moveaxis(1, 0)``), so each data shard keeps its rows."""
    b = x.shape[0]
    if b % grad_accum:
        raise ValueError(f"batch {b} is not a multiple of grad_accum "
                         f"{grad_accum}")
    return x.reshape(b // grad_accum, grad_accum, *x.shape[1:]).movedim(1, 0)


def _data_dim(spec):
    """The dim a leaf's spec splits over ``data`` (FSDP), or None."""
    for d, entry in enumerate(spec):
        if "data" in spec_axes(entry):
            return d
    return None


def batch_rows(place, x):
    """This data rank's rows of a global batch leaf (every row where they
    do not split over ``data``, as ``batch_spec`` places them)."""
    if x.shape[0] % place.sizes["data"]:
        return x
    return place.data.part(x, 0)


def gather_data(place, specs, params, cast=None):
    """The leaves split over ``data`` all-gathered (after ``cast``): this
    rank's tensor-parallel params, the placed model's input."""
    def one(x, spec):
        x = x if cast is None else cast(x)
        d = _data_dim(spec)
        return x if d is None else place.data.all_gather(x, d)
    return tree_map(one, params, specs)


def make_train_step(model, opt_update, *, grad_accum: int = 1,
                    clip: float = 1.0, compression: str = "none",
                    gather_dtype=None, mesh=None):
    """Returns train_step(params, opt_state[, residuals], batch) ->
    (params, opt_state[, residuals], {"loss", "grad_norm"}).

    ``gather_dtype=torch.bfloat16`` casts float matrices to bf16 before
    the loss (the reference does it before its FSDP all-gather; over a
    mesh so does this step); the optimizer still updates the f32 master
    weights.  ``mesh``: the step of this rank of a ``(data, model)``
    mesh (see the module docstring; ``model.on_mesh`` raises for the
    families not ported over a mesh)."""
    if compression not in ("none", "bf16", "int8"):
        raise ValueError(f"compression {compression!r}: none, bf16 or int8")

    def cast(x):
        return (x.to(gather_dtype) if gather_dtype is not None and
                x.dim() >= 2 and x.dtype == torch.float32 else x)

    def cast_for_compute(p):
        return p if gather_dtype is None else tree_map(cast, p)

    def value_and_grad(params, mb, prepare):
        leaves = tree_leaves(params)
        live = [x.detach().requires_grad_(True) for x in leaves]
        it = iter(live)
        p = tree_map(lambda _: next(it), params)
        loss, _ = model.loss(prepare(p), mb)
        grads = torch.autograd.grad(loss, live)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it).float(), params)

    def accumulate(params, batch, prepare=cast_for_compute):
        if grad_accum == 1:
            return value_and_grad(params, batch, prepare)
        mbs = {k: _split(v, grad_accum) for k, v in batch.items()}
        grads = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                               device=x.device), params)
        lsum = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        for i in range(grad_accum):
            loss, g = value_and_grad(params, {k: v[i] for k, v in
                                              mbs.items()}, prepare)
            tree_map(lambda a, b: a.add_(b), grads, g)
            lsum = lsum + loss
            del g
        inv = 1.0 / grad_accum
        tree_map(lambda a: a.mul_(inv), grads)
        return lsum * inv, grads

    compute_grads, sum_squares, groups = accumulate, None, None
    if mesh is not None:
        model = model.on_mesh(mesh)
        place, specs = model.place, model.specs

        def reduce(g, spec):
            d = _data_dim(spec)
            return (place.data.all_reduce(g) if d is None else
                    place.data.reduce_scatter(g, d))

        def compute_grads(params, batch):
            with torch.no_grad():
                full = gather_data(place, specs, params, cast)
            loss, grads = accumulate(
                full, {k: batch_rows(place, v) for k, v in batch.items()},
                lambda p: p)
            del full
            return loss, tree_map(reduce, grads, specs)

        def owned(spec):
            """Whether this rank counts a leaf's shard in the norm: its
            index is 0 on every axis that does not split the leaf."""
            axes = {a for e in spec for a in spec_axes(e)}
            return all(place.coord[a] == 0 for a in place.sizes
                       if a not in axes)

        def sum_squares(grads):
            total = [torch.zeros((), dtype=torch.float32,
                                 device=tree_leaves(grads)[0].device)]

            def add(g, spec):
                if owned(spec):
                    total[0] = total[0] + torch.sum(torch.square(g.float()))
            tree_map(add, grads, specs)
            return place.world.all_reduce(total[0])

        def row_group(spec):
            """The axis over which a leaf's int8 rows are split: those of
            its dims past the first (a stacked leaf's row is a whole
            layer), or of its one dim."""
            rest = spec[1:] if len(spec) > 1 else spec
            return place.over({a for e in rest for a in spec_axes(e)})

        groups = tree_map(row_group, specs)

    if compression == "none":
        def train_step(params, opt_state, batch):
            loss, grads = compute_grads(params, batch)
            grads, gn = clip_by_global_norm(grads, clip, sum_squares)
            params, opt_state = opt_update(grads, opt_state, params)
            return params, opt_state, {"loss": loss, "grad_norm": gn}
    else:
        def train_step(params, opt_state, residuals, batch):
            loss, grads = compute_grads(params, batch)
            grads, residuals = comp.compress_grads(grads, residuals,
                                                   compression, groups)
            grads, gn = clip_by_global_norm(grads, clip, sum_squares)
            params, opt_state = opt_update(grads, opt_state, params)
            return (params, opt_state, residuals,
                    {"loss": loss, "grad_norm": gn})
    # over a mesh: the rank's placement (its collectives' counts)
    train_step.placement = model.place if mesh is not None else None
    return train_step
