"""Pipeline parallelism over the ``pod`` axis (the GPipe schedule); the port
of ``repro.runtime.pipeline_par``.

Stage *i* of ``S`` holds layers ``[i L / S, (i + 1) L / S)`` of a
transformer-family model; the embedding, ``final_norm`` and ``lm_head``
are replicated on every stage (stage 0 embeds, the last stage takes the
loss), the batch's rows are split over ``data``, and a ``model`` axis,
where the mesh has one, replicates the work, as the reference's
``shard_map`` specs do.  Only hidden states travel between stages.

The reference writes the schedule as ticks of a ``lax.scan`` and lets
autodiff reverse the ``ppermute``s.  Autograd fixes no order for
independent point-to-point sends, so the port runs an explicit schedule
inside one ``torch.autograd.Function``: the forward runs every
microbatch through this rank's stage in order (receive the input from
the stage before, run the layers keeping the graph, send the output on;
the last stage sums the NLL), the backward runs the microbatches in
reverse order (receive the output's gradient, ``torch.autograd.backward``
through the stage, send the input's gradient back).  Sends and receives
are blocking and pair in microbatch order along the chain of stages, so
no ring forms.  The reference's dead ticks (a stage idle before its first
or after its last microbatch) add zero; the port does not run them.

A caller takes the gradients with ``loss.backward()`` on the returned
loss (or ``loss_fn.value_and_grad``): each leaf of this rank's params
gets the gradient of the global loss, summed where the leaf is
replicated: over ``pod`` and ``data`` for the embedding, ``final_norm``
and ``lm_head`` (a tied table takes stage 0's embedding share and the
last stage's unembedding share), over ``data`` for the layer slice.
That is the one-process ``model.loss`` gradient of the same leaf.
:func:`stage_params` places a whole tree, :func:`gather_stages` puts the
slices back.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import MeshPlacement
from repro_torch.models import layers as L
from repro_torch.models.transformer import (TransformerLM, layer_params,
                                            unbind_layers)
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import sharding as shd


def pipeline_specs(params, stage_axis: str = "pod"):
    """The spec tree of a pipeline's params: each leaf under ``layers``
    split over ``stage_axis`` on its layer dim, every other leaf
    replicated."""
    def visit(tree, in_layers):
        if isinstance(tree, dict):
            return {k: visit(v, in_layers or k == "layers")
                    for k, v in tree.items()}
        return ((stage_axis,) + (None,) * (tree.dim() - 1) if in_layers
                else (None,) * tree.dim())
    return visit(params, False)


def stage_params(params, mesh, stage_axis: str = "pod"):
    """This rank's params of the pipeline: its stage's slice of
    ``layers``, and the rest whole (no communication)."""
    return shd.shard_tree(params, mesh, pipeline_specs(params, stage_axis))


def gather_stages(tree, mesh, stage_axis: str = "pod"):
    """The whole tree from every rank's :func:`stage_params`-placed one
    (a tree of params or of their gradients), on every rank."""
    return shd.gather_tree(tree, mesh, pipeline_specs(tree, stage_axis))


class _GPipe:
    """One rank's schedule: its stage of ``impl``'s layers over ``M``
    microbatches."""

    def __init__(self, impl, place, stages, n_microbatches):
        self.impl, self.place, self.stages = impl, place, stages
        self.m = n_microbatches

    def _stage(self, layers, h, train: bool):
        n = next(iter(tree_leaves(layers))).shape[0]
        per = (unbind_layers(layers, n) if train else
               [layer_params(layers, i) for i in range(n)])
        for lp in per:
            h = self.impl._layer(h, lp)[0]
        return h

    def _tail(self, params, h, labels):
        impl = self.impl
        h = L.apply_norm(params["final_norm"], h, impl.cfg.norm)
        return L.nll_sum(impl._unembed(params, h), labels)

    def forward(self, template, tokens, labels, live, train: bool):
        """(the global loss, what the backward needs)."""
        impl, stages = self.impl, self.stages
        it = iter(live)
        params = tree_map(lambda _: next(it), template)
        s, last = stages.index, stages.size - 1
        mb = tokens.shape[0] // self.m
        toks = tokens.reshape(self.m, mb, -1)
        labs = labels.reshape(self.m, mb, -1)
        like = torch.empty((mb, toks.shape[-1], impl.cfg.d_model),
                           dtype=torch.float32, device=tokens.device)
        sums = torch.zeros(2, dtype=torch.float32, device=tokens.device)
        kept = []
        with torch.set_grad_enabled(train):
            for m in range(self.m):
                h_in = None
                if s == 0:
                    h = impl._inputs_to_h(params, {"tokens": toks[m]})
                else:
                    h_in = stages.recv(like, s - 1).requires_grad_(train)
                    h = h_in.to(impl.compute_dtype)
                h = self._stage(params["layers"], h, train)
                if s < last:
                    stages.send(h.float(), s + 1)
                    kept.append((h_in, h))
                else:
                    nll, cnt = self._tail(params, h, labs[m])
                    sums = sums + torch.stack([nll.detach(), cnt])
                    kept.append((h_in, nll))
        sums = self.place.data.all_reduce(stages.all_reduce(sums))
        count = torch.clamp(sums[1], min=1.0)
        return sums[0] / count, {"kept": kept if train else None,
                                 "count": count, "live": live,
                                 "template": template}

    def backward(self, state, g):
        """The gradients of this rank's leaves (``None`` where a leaf
        takes none), summed over the axes that replicate it."""
        stages, data = self.stages, self.place.data
        s, last = stages.index, stages.size - 1
        kept = state["kept"]
        for m in reversed(range(self.m)):
            h_in, out = kept[m]
            if s == last:
                torch.autograd.backward(out, (g / state["count"]).to(
                    out.dtype))
            else:
                like = torch.empty(out.shape, dtype=torch.float32,
                                   device=out.device)
                torch.autograd.backward(
                    out, stages.recv(like, s + 1).to(out.dtype))
            if h_in is not None:
                stages.send(h_in.grad, s - 1)
            kept[m] = None

        def reduce(x, in_layers):
            if not x.requires_grad:
                return None
            gx = x.grad if x.grad is not None else torch.zeros_like(x)
            return data.all_reduce(gx if in_layers else
                                   stages.all_reduce(gx))

        it = iter(state["live"])

        def visit(tree, in_layers):
            if isinstance(tree, dict):
                return {k: visit(v, in_layers or k == "layers")
                        for k, v in tree.items()}
            return reduce(next(it), in_layers)
        return tree_leaves(visit(state["template"], False))


class _PipelineLoss(torch.autograd.Function):
    """The whole schedule as one autograd node over this rank's leaves."""

    @staticmethod
    def forward(ctx, run, template, tokens, labels, train, *leaves):
        live = [x.detach().requires_grad_(x.requires_grad and train)
                for x in leaves]
        loss, state = run.forward(template, tokens, labels, live, train)
        ctx.run, ctx.state = run, state
        return loss

    @staticmethod
    def backward(ctx, g):
        grads = ctx.run.backward(ctx.state, g)
        ctx.state = None
        return (None, None, None, None, None, *grads)


def make_pipeline_loss(model, mesh, *, n_microbatches: int,
                       stage_axis: str = "pod"):
    """``loss_fn(params, batch)``: the transformer's loss run as a GPipe
    pipeline over ``stage_axis`` of ``mesh`` (a ``DeviceMesh`` over every
    rank of the group).  ``params`` are this rank's
    (:func:`stage_params`); ``batch`` is the global ``tokens`` and
    ``labels`` [B, S], of which this rank takes its ``data`` rows.
    Returns ``Σ nll / max(Σ count, 1)`` over every microbatch of every
    ``data`` rank, the same value on every rank; ``loss.backward()``
    gives each leaf its gradient (module docstring).  The stage body is
    the plain layer, no remat, as in the reference.
    ``loss_fn.value_and_grad(params, batch)`` returns (loss, the
    gradient tree) and ``loss_fn.placement`` is the rank's
    :class:`~repro_torch.launch.mesh.MeshPlacement` (``stats``: its
    sends and collectives).

    Raises ``TypeError`` for a model that is not a (one-process)
    transformer, ``ValueError`` where ``n_layers`` does not divide over
    the stages or the batch over ``data`` x ``n_microbatches``."""
    impl = getattr(model, "impl", model)
    if not isinstance(impl, TransformerLM) or impl.place is not None:
        raise TypeError(f"the pipeline takes a one-process TransformerLM, "
                        f"not {type(impl).__name__}")
    cfg = impl.cfg
    place = MeshPlacement(mesh)
    if stage_axis not in place.names:
        raise ValueError(f"mesh axes {place.names} have no {stage_axis!r}")
    stages = place.axes[stage_axis]
    if cfg.n_layers % stages.size:
        raise ValueError(f"{cfg.n_layers} layers do not divide over "
                         f"{stages.size} stages")
    run = _GPipe(impl, place, stages, n_microbatches)

    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        n = place.sizes["data"] * n_microbatches
        if tokens.shape[0] % n:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{n_microbatches} microbatches on each of "
                             f"{place.sizes['data']} data ranks")
        tokens, labels = (place.data.part(x, 0) for x in (tokens, labels))
        leaves = tree_leaves(params)
        train = torch.is_grad_enabled() and any(x.requires_grad
                                                for x in leaves)
        return _PipelineLoss.apply(run, params, tokens, labels, train,
                                   *leaves)

    def value_and_grad(params, batch):
        leaves = tree_leaves(params)
        live = [x.detach().requires_grad_(x.is_floating_point())
                for x in leaves]
        it = iter(live)
        loss = loss_fn(tree_map(lambda _: next(it), params), batch)
        grads = torch.autograd.grad(loss, [x for x in live
                                           if x.requires_grad])
        it = iter(grads)
        return loss.detach(), tree_map(
            lambda x: next(it) if x.is_floating_point() else None, params)

    loss_fn.value_and_grad = value_and_grad
    loss_fn.placement = place
    return loss_fn
