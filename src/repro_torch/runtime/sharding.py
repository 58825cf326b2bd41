"""Sharding rules: map the port's param / batch / cache trees to specs
over a device mesh; the port of ``repro.runtime.sharding``.

A spec is a tuple with one entry per tensor dim, as a ``PartitionSpec``
is: a mesh axis name, a tuple of names (the dim split over their
product), or ``None`` (replicated); ``()`` replicates a tensor whole.
:func:`to_placements` turns one into ``torch.distributed.tensor``
placements.  A mesh is a ``DeviceMesh`` with ``mesh_dim_names``, or a
``{name: size}`` dict (the rules read only the axis sizes).
:func:`shard_tree` and :func:`gather_tree` are the counterpart of the
reference's ``device_put(tree, NamedSharding(mesh, spec))`` and of
reading the placed arrays back whole: a rank keeps the slice of each leaf
its mesh coordinate names.

Axis roles:
  * ``model``: tensor parallelism (heads / ffn / vocab / experts) and, for
    decode, the **KV-cache sequence dimension**: each model shard is one
    "DockerSSD" of the computing-enabled storage pool, owning a contiguous
    KV extent (the paper's D-Cache placement).
  * ``data`` (+ ``pod`` when present): batch data parallelism and
    ZeRO-3-style FSDP of the weights.

Every axis assignment is divisibility-guarded: if a dim does not divide
by the axis size the next-smaller axis subset (or replication) is used,
so the same rules serve every arch and mesh.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]

#: the mesh axis of the storage pool: one DockerSSD node a shard
POOL_AXIS = "model"


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a dict of sizes."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def fsdp_axes(mesh):
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def batch_axes(mesh):
    return fsdp_axes(mesh)


def _axes_size(mesh, axes) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in axes) if axes else 1


def axes_if_div(mesh, dim: int, axes) -> Optional[tuple]:
    """Largest prefix-subset of ``axes`` whose product divides ``dim``."""
    axes = tuple(axes)
    while axes:
        if dim % _axes_size(mesh, axes) == 0:
            return axes
        axes = axes[:-1]
    return None


def _ax(mesh, dim: int, *axes) -> Any:
    got = axes_if_div(mesh, dim, axes)
    if got is None:
        return None
    return got if len(got) > 1 else got[0]


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "w", "wr", "wg",
                 "in_proj", "lora_a", "wa"}
_ROW_PARALLEL = {"wo", "w_down", "wv_cm", "out_proj", "wb"}
_REPLICATED = {"scale", "bias", "b_up", "b_down", "bq", "bk", "bv",
               "router", "w0", "u", "ln_x", "a_log", "d_skip", "dt_bias",
               "conv_b", "lora_b", "mu_x", "mu_w", "mu_k", "mu_v", "mu_r",
               "mu_g"}


def param_spec(mesh, path: Sequence[str], shape) -> Spec:
    """Spec for one parameter leaf given its key path and shape."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    fa = fsdp_axes(mesh)
    stacked = "layers" in path            # leading layer dim of the stack
    shape = tuple(shape)
    core = shape[1:] if stacked else shape
    lead = (None,) if stacked else ()

    def done(*spec):
        return lead + spec

    # --- special cases -----------------------------------------------------
    if parent == "embed" and name == "table":
        v, d = core
        s0 = _ax(mesh, v, "model")
        if s0 is not None:
            return done(s0, _ax(mesh, d, *fa))
        return done(None, _ax(mesh, d, "model"))
    if parent == "lm_head" and name == "w":
        d, v = core
        s1 = _ax(mesh, v, "model")
        if s1 is not None:
            return done(_ax(mesh, d, *fa), s1)
        return done(_ax(mesh, d, "model"), None)
    if parent == "mlp" and len(core) == 3:            # MoE expert weights
        e = core[0]
        se = _ax(mesh, e, "model")
        return done(se, _ax(mesh, core[1], *fa), None)
    if name == "conv_w":                              # [D_CONV, conv_dim]
        return done(None, _ax(mesh, core[-1], "model"))
    # rwkv channel-mix wv is row-parallel [d_ff, d]
    if name == "wv" and parent == "channel_mix":
        return done(_ax(mesh, core[0], "model"), _ax(mesh, core[1], *fa))
    if name in _REPLICATED or len(core) < 2:
        return done(*([None] * len(core)))
    if name in _ROW_PARALLEL:
        return done(_ax(mesh, core[0], "model"), _ax(mesh, core[1], *fa))
    if name in _COL_PARALLEL:
        return done(_ax(mesh, core[0], *fa), _ax(mesh, core[1], "model"))
    # default: replicate
    return done(*([None] * len(core)))


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's (or anything with ``.shape``), the
    first item of a ``(shape, dtype)`` pair (``cache_spec``'s leaves), or
    ``()`` for a host int (the dense cache's ``index``)."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    if isinstance(leaf, tuple) and leaf and isinstance(leaf[0], tuple):
        return leaf[0]
    return ()


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(mesh, params) -> Any:
    """Spec tree matching ``params`` (the port's nested dicts, the
    reference's layout; tensors or anything with a ``.shape``)."""
    return _map_with_path(lambda path, leaf: param_spec(mesh, path,
                                                        _shape(leaf)), params)


def serve_param_specs(mesh, params) -> Any:
    """Serving-time param specs: TP (model axis) only, no ZeRO/FSDP
    sharding over the data axes.  Decode reads every weight once per
    token; FSDP would force a full parameter all-gather per step.
    Serving replicates over data/pod and shards over model."""
    fa = set(fsdp_axes(mesh))

    def keep(ax):
        if ax is None:
            return None
        if isinstance(ax, tuple):
            kept = tuple(a for a in ax if a not in fa)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return None if ax in fa else ax

    return _map_with_path(lambda _, spec: tuple(keep(ax) for ax in spec),
                          param_specs(mesh, params))


# ---------------------------------------------------------------------------
# activation / batch / cache specs
# ---------------------------------------------------------------------------


def batch_spec(mesh, specs) -> Any:
    """Specs for a train/prefill input batch dict."""
    ba = batch_axes(mesh)

    def one(_, leaf):
        shape = _shape(leaf)
        s0 = _ax(mesh, shape[0], *ba)
        rest = [None] * (len(shape) - 1)
        if len(shape) == 3:  # embeds [B,S,d]: shard d over model
            rest[-1] = _ax(mesh, shape[-1], "model")
        return (s0, *rest)

    return _map_with_path(one, specs)


def cache_spec_shardings(mesh, cache_specs, multi_pod_seq: bool = True):
    """Specs for a decode cache tree.

    KV tensors [L, B, Hkv, S, D]: batch -> data axes, **sequence -> model
    (+ pod)**, the D-Cache storage-pool placement.  SSM/conv/shift states:
    batch -> data axes, feature dim -> model when divisible.
    """
    ba = batch_axes(mesh)
    names = mesh_axes(mesh)
    seq_axes = ("pod", "model") if ("pod" in names and
                                    multi_pod_seq) else ("model",)

    def one(keys, leaf):
        shape = _shape(leaf)
        if keys and keys[-1] in ("k", "v") and len(shape) == 5:
            _, b, _, s, _ = shape
            return (None, _ax(mesh, b, "data"), None, _ax(mesh, s, *seq_axes),
                    None)
        if keys and keys[-1] in ("k_scale", "v_scale") and len(shape) == 4:
            _, b, _, s = shape
            return (None, _ax(mesh, b, "data"), None,
                    _ax(mesh, s, *seq_axes))
        if keys and keys[-1] == "index":
            return ()
        # states: [L, B, ...feature...]
        if len(shape) >= 3:
            sb = _ax(mesh, shape[1], *ba)
            rest = [None] * (len(shape) - 2)
            rest[-1] = _ax(mesh, shape[-1], "model")
            return (None, sb, *rest)
        return (None,) * len(shape)

    return _map_with_path(one, cache_specs)


def decode_token_spec(mesh, batch: int) -> Spec:
    return (_ax(mesh, batch, "data"),)


def to_placements(mesh, spec: Spec):
    """``torch.distributed.tensor`` placements of ``spec`` over ``mesh``:
    for each mesh dim, ``Shard(d)`` where tensor dim ``d``'s entry names
    that axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh_axes(mesh):
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


# ---------------------------------------------------------------------------
# placing trees: a rank's slices, and the whole leaves back
# ---------------------------------------------------------------------------


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry: ``()``, ``(name,)`` or a tuple's
    names (the dim split over their product, the first one major)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def mesh_coordinate(mesh) -> Dict[str, int]:
    """This rank's {axis: index} on a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _block(sizes, coord, axes) -> Tuple[int, int]:
    """(index, count) of the block that ``coord`` holds of a dim split
    over ``axes``: row-major over the axes, as a ``PartitionSpec``'s
    tuple entry splits it."""
    idx, n = 0, 1
    for a in axes:
        idx, n = idx * sizes[a] + coord[a], n * sizes[a]
    return idx, n


def shard_leaf(x, sizes, coord, spec):
    """``x``'s slice at mesh coordinate ``coord`` ({axis: index}) under
    ``spec``: a contiguous copy (of the whole tensor where the spec
    splits nothing: the step updates its leaves in place; a non-tensor
    as it is)."""
    if not isinstance(x, torch.Tensor):
        return x
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            idx, n = _block(sizes, coord, axes)
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split over {axes} ({n})")
            w = x.shape[d] // n
            x = x.narrow(d, idx * w, w)
    return x.clone(memory_format=torch.contiguous_format)


def assemble_leaf(shards: Dict[tuple, Any], mesh, spec):
    """The whole leaf from ``shards`` ({coordinate tuple in the mesh's
    axis order: that coordinate's slice}; every coordinate of the mesh,
    as :func:`shard_leaf` cut them), the inverse of :func:`shard_leaf`."""
    sizes = mesh_axes(mesh)
    names = tuple(sizes)
    first = next(iter(shards.values()))
    if not isinstance(first, torch.Tensor) or not any(spec_axes(e)
                                                      for e in spec):
        return first
    out = None
    for key, part in shards.items():
        coord = dict(zip(names, key))
        if out is None:
            shape = list(part.shape)
            for d, entry in enumerate(spec):
                shape[d] *= _block(sizes, coord, spec_axes(entry))[1]
            out = part.new_empty(shape)
        view = out
        for d, entry in enumerate(spec):
            axes = spec_axes(entry)
            if axes:
                idx, _ = _block(sizes, coord, axes)
                view = view.narrow(d, idx * part.shape[d], part.shape[d])
        view.copy_(part)
    return out


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree (nested dicts and NamedTuples, as
    the params and the AdamW state) and its spec tree."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, v, s)
                            for v, s in zip(tree, specs)))
    return fn(tree, specs)


def shard_tree(tree, mesh, specs, coord: Optional[Dict[str, int]] = None):
    """This rank's slice of every leaf of ``tree`` under ``specs`` (the
    spec tree of ``param_specs`` / ``cache_spec_shardings`` / ...; for
    an AdamW state ``AdamWState(step=(), m=specs, v=specs)``), by its
    coordinate on ``mesh`` (``coord`` given: that coordinate, and
    ``mesh`` may be a dict of sizes).  No communication: every rank
    holds the whole tree and keeps its slices."""
    sizes = mesh_axes(mesh)
    if coord is None:
        coord = mesh_coordinate(mesh)
    return _zip_map(lambda x, sp: shard_leaf(x, sizes, coord, sp), tree,
                    specs)


def gather_tree(tree, mesh, specs, dst: Optional[int] = None):
    """The whole leaves of a tree placed by :func:`shard_tree`: each split
    leaf's slices all-gathered over every rank of ``mesh`` (a
    ``DeviceMesh`` over the whole default group) and put back in
    place.  Every rank gets the whole tree; replicated leaves are
    returned as they are.  With ``dst`` (a rank) the slices travel
    through the host to that rank alone, one leaf at a time: it gets the
    whole tree on the CPU, every other rank ``None`` (a tree too large
    to assemble on every rank's card)."""
    import torch.distributed as dist

    names = tuple(mesh.mesh_dim_names)
    grid = mesh.mesh
    coords = {int(grid[idx]): idx for idx in
              itertools.product(*map(range, grid.shape))}
    n = grid.numel()
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks over a group of "
                         f"{dist.get_world_size()}")
    mine = dst is None or dist.get_rank() == dst

    def one(x, spec):
        if not isinstance(x, torch.Tensor) or not any(spec_axes(e)
                                                      for e in spec):
            if dst is None or not isinstance(x, torch.Tensor):
                return x
            return x.cpu() if mine else None
        if dst is None:
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x)
        else:
            x = x.detach().cpu().contiguous()
            parts = [torch.empty_like(x) for _ in range(n)] if mine else None
            dist.gather(x, parts, dst=dst)
            if not mine:
                return None
        return assemble_leaf({coords[r]: p for r, p in enumerate(parts)},
                             dict(zip(names, grid.shape)), spec)

    out = _zip_map(one, tree, specs)
    return out if mine else None


# ---------------------------------------------------------------------------
# pool serving specs (PoolServer: one DockerSSD node per ``model`` shard)
# ---------------------------------------------------------------------------


def mesh_bucket(n: int) -> int:
    """Pow2 capacity bucket for an elastic pool of ``n`` nodes:
    membership changes inside the bucket keep every node's window (shards
    park and unpark), and growing past it means provisioning a new
    server.  Pow2 keeps the bucket count logarithmic in pool size."""
    if n < 1:
        raise ValueError(f"pool capacity must be >= 1, got {n}")
    return 1 << (n - 1).bit_length()


def pool_mesh(capacity: int, devices=None, device_type: str = "cuda"):
    """The pool mesh: a 1-D ``DeviceMesh`` named ``("model",)`` over
    ``capacity`` ranks of the default process group (one DockerSSD node a
    rank), the first ``capacity`` of ``devices`` (rank ids; default
    every rank).  Raises when the group has too few ranks, with the
    ``torchrun`` hint, as the reference raises for too few devices."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a pool mesh of {capacity} nodes needs a process group: start "
            f"{capacity} ranks (torchrun --nproc-per-node {capacity}) and "
            "join them (launch.mesh.init_ranks)")
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    if capacity > len(ranks):
        raise ValueError(
            f"{capacity} pool nodes need {capacity} ranks but only "
            f"{len(ranks)} are in the process group; start them with "
            f"torchrun --nproc-per-node {capacity}")
    return DeviceMesh(device_type, torch.tensor(ranks[:capacity]),
                      mesh_dim_names=(POOL_AXIS,))


def pool_store_spec() -> Spec:
    """Spec for the stacked PageStore arrays ``[n_layers, hbm_pages, page,
    Hkv, D]``: the *pages* axis is sharded over ``model``, shard i's
    contiguous physical range is node i's window, the D-Cache placement
    at page granularity.  Layers, page interior, heads stay local."""
    return (None, "model", None, None, None)


def pool_state_spec(quantized: bool = False) -> dict:
    """Spec dict for the ``PageStore.device_state`` tree: the page arrays
    shard over ``model`` along the pages axis, and for quantized stores
    the per-slot scale arrays ``[n_layers, hbm_pages, page, Hkv]`` along
    the same pages axis: a node owns its pages' codes and their scales,
    so dequant is node-local."""
    st = {"k": pool_store_spec(), "v": pool_store_spec()}
    if quantized:
        st["ks"] = (None, "model", None, None)
        st["vs"] = (None, "model", None, None)
    return st


def pool_step_specs(quantized: bool = False):
    """(in_specs, out_specs) of the pool decode step ``(params, state,
    page_table, lengths, tokens) -> (logits, state)``.  Params and the
    control tensors are replicated (every node runs the full layer stack;
    each DockerSSD stores the whole model), only the page windows (and
    their scale windows) are split."""
    store = pool_state_spec(quantized)
    return (((), store, (), (), ()),
            ((), store))


def pool_chunk_specs(quantized: bool = False):
    """(in_specs, out_specs) of the prefill chunk ``(params, state,
    page_row, tokens, start, n_valid) -> (logits, state)``: the chunk's
    page row, tokens and scalars are replicated control, the logits come
    out identical on every node (each merges the same partials)."""
    store = pool_state_spec(quantized)
    return (((), store, (), (), (), ()),
            ((), store))


def pool_horizon_specs(quantized: bool = False):
    """(in_specs, out_specs) of the fused decode horizon ``(params, state,
    page_table, lengths, tokens, budget, eos_id, key, temperature, top_p,
    streams) -> (emitted, logits, state)``: only the page windows are
    split; the control carries are replicated arithmetic, and the emitted
    tokens and logits are the same on every node."""
    store = pool_state_spec(quantized)
    return (((), store, (), (), (), (), (), (), (), (), ()),
            ((), (), store))


def pool_spec_specs(quantized: bool = False):
    """(in_specs, out_specs) of the speculative draft-verify pass
    ``(params, state, page_table, lengths, tokens, budget, eos_id, hist,
    hist_len, key, temperature, top_p, streams) -> (packed, state)``: the
    drafter's history rides replicated like the page table, and only the
    page windows are split."""
    store = pool_state_spec(quantized)
    return (((), store, (), (), (), (), (), (), (), (), (), (), ()),
            ((), store))
