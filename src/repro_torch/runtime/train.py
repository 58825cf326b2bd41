"""Training step factory (the port of ``repro.runtime.train``):
gradient accumulation over microbatches, global-norm clipping, AdamW,
and optional gradient compression with error feedback.

Gradients come from ``torch.autograd.grad`` on detached copies of the
params that require a gradient; they and their sum are f32.  The step
updates params and the optimizer state in place (the JAX step donates
both) and returns them.

Over a mesh (``make_train_step(..., mesh=)``) the step runs on each rank
of a ``(pod, data, model)`` mesh (any of the axes may be missing):
params, the AdamW moments and the compression residuals are this rank's
shards (``runtime.sharding.shard_tree`` under ``param_specs``), the
batch is the global one and each rank takes its rows, split over ``(pod,
data)`` or, where the batch does not divide, over ``pod`` alone
(``MeshPlacement.rows_axis``, the reference's ``axes_if_div``).  Leaves
split over the FSDP axes their spec entry names (``("pod", "data")``,
``("pod",)`` or ``"data"``: ZeRO-3 / FSDP) are all-gathered over those
axes before the loss and their gradients reduce-scattered over them (the
gather's backward, which is also the data-parallel reduction), then
all-reduced over the FSDP axes the leaf does not split over; leaves
replicated over ``(pod, data)`` have their gradients all-reduced over
it.  The loss is the mean over every ``(pod, data)`` rank's valid
tokens, the clip's norm counts each element once, int8 compression takes
each row's max over the row's shards, and AdamW updates each shard in
place.
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


#: the axes the batch and the FSDP shards split over
FSDP_AXES = ("pod", "data")


def _fsdp_dim(spec):
    """(the dim a leaf's spec splits over FSDP axes, those axes), or
    (None, ())."""
    for d, entry in enumerate(spec):
        axes = tuple(a for a in spec_axes(entry) if a in FSDP_AXES)
        if axes:
            return d, axes
    return None, ()


def split_rows(rows, x):
    """This rank's rows of a global batch leaf over ``rows`` (an axis from
    ``MeshPlacement.rows_axis``; ``None``: every row)."""
    return x if rows is None else rows.part(x, 0)


def join_rows(rows, x):
    """The global rows of ``x`` from every rank of ``rows``."""
    return x if rows is None else rows.all_gather(x, 0)


def gather_data(place, specs, params, cast=None):
    """The leaves split over FSDP axes all-gathered over them (after
    ``cast``): this rank's tensor-parallel params, the placed model's
    input."""
    def one(x, spec):
        x = x if cast is None else cast(x)
        d, axes = _fsdp_dim(spec)
        return x if d is None else place.over(axes).all_gather(x, d)
    return tree_map(one, params, specs)


def make_train_step(model, opt_update, *, grad_accum: int = 1,
                    clip: float = 1.0, compression: str = "none",
                    gather_dtype=None, mesh=None):
    """Returns train_step(params, opt_state[, residuals], batch) ->
    (params, opt_state[, residuals], {"loss", "grad_norm"}).

    ``gather_dtype=torch.bfloat16`` casts float matrices to bf16 before
    the loss (the reference does it before its FSDP all-gather; over a
    mesh so does this step); the optimizer still updates the f32 master
    weights.  ``mesh``: the step of this rank of a ``(pod, data, model)``
    mesh (see the module docstring; ``model.on_mesh`` raises where the
    model's heads or products do not split over ``model``)."""
    if compression not in ("none", "bf16", "int8"):
        raise ValueError(f"compression {compression!r}: none, bf16 or int8")

    def cast(x):
        return (x.to(gather_dtype) if gather_dtype is not None and
                x.dim() >= 2 and x.dtype == torch.float32 else x)

    def cast_for_compute(p):
        return p if gather_dtype is None else tree_map(cast, p)

    def value_and_grad(params, mb, prepare, model):
        leaves = tree_leaves(params)
        live = [x.detach().requires_grad_(True) for x in leaves]
        it = iter(live)
        p = tree_map(lambda _: next(it), params)
        loss, _ = model.loss(prepare(p), mb)
        grads = torch.autograd.grad(loss, live)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it).float(), params)

    def accumulate(params, batch, prepare=cast_for_compute, model=model):
        if grad_accum == 1:
            return value_and_grad(params, batch, prepare, model)
        mbs = {k: _split(v, grad_accum) for k, v in batch.items()}
        grads = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                               device=x.device), params)
        lsum = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        for i in range(grad_accum):
            loss, g = value_and_grad(params, {k: v[i] for k, v in
                                              mbs.items()}, prepare, model)
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
            """Summed over every (pod, data) rank: reduce-scattered over
            the FSDP axes the leaf splits over, all-reduced over the
            others."""
            d, axes = _fsdp_dim(spec)
            if d is not None:
                g = place.over(axes).reduce_scatter(g, d)
            rest = place.over(a for a in FSDP_AXES if a not in axes)
            return g if rest is None else rest.all_reduce(g)

        def compute_grads(params, batch):
            rows = place.rows_axis(next(iter(batch.values())).shape[0])
            with torch.no_grad():
                full = gather_data(place, specs, params, cast)
            loss, grads = accumulate(
                full, {k: split_rows(rows, v) for k, v in batch.items()},
                lambda p: p, model.with_rows(rows))
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
