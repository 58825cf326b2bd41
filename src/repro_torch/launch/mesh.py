"""Process groups and device meshes over ``torch.distributed`` ranks; the
port of ``repro.launch.mesh``.

One rank is one process.  :func:`init_ranks` joins this process to the
default group with the backend :func:`pick_backend` names, before any
``DeviceMesh`` is built: ``init_device_mesh("cuda", ...)`` would
otherwise create an NCCL group, which refuses two ranks on one card.
The mesh factories keep the reference's shape arithmetic and return a
``DeviceMesh`` with ``mesh_dim_names``.  :func:`run_ranks` starts N
ranks of a function on this host (``torch.multiprocessing``, a
``FileStore`` rendezvous: no TCP port) and joins them with a time
limit.  :class:`MeshPlacement` gives a rank's place on a ``(pod, data,
model)`` mesh: its coordinate and one :class:`MeshAxis` (the axis's
process group and its counted collectives) an axis or set of axes.  The
model code places the batch and the FSDP shards over ``fsdp`` (``(pod,
data)``), tensor parallelism over ``model`` and the decode cache's
sequence over ``seq`` (``(pod, model)``), as the reference's sharding
rules do; the GPipe pipeline (``runtime.pipeline_par``) takes ``pod`` as
its stage axis.
``make_production_mesh`` is not
ported: it serves the reference's XLA dry run on a faked 512-device
mesh.
"""
from __future__ import annotations

import collections
import datetime
import itertools
import math
import os
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch


def pick_backend(device_type: str, local_ranks: int,
                 n_cards: Optional[int] = None) -> str:
    """The one rule: NCCL when the ranks are on cards and every rank of
    this host has a card of its own (``local_ranks <= n_cards``); gloo on
    the CPU and when several ranks share one card (NCCL refuses two ranks
    on one card; gloo takes CUDA tensors for ``all_reduce`` and
    ``broadcast`` and stages them through the host)."""
    if device_type != "cuda":
        return "gloo"
    if n_cards is None:
        n_cards = torch.cuda.device_count()
    return "nccl" if 0 < local_ranks <= n_cards else "gloo"


#: how long a collective may wait for its peers before it raises
COLLECTIVE_TIMEOUT_S = 300


def init_ranks(device_type: str = "cuda", *, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: Optional[str] = None, store=None,
               verbose: bool = True) -> Tuple[str, torch.device]:
    """Join this process to the default process group and return
    (backend, this rank's device).

    Rank and world size come from the arguments, else from the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, and
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` for the card); the rendezvous
    from ``store`` (a ``FileStore``, what the tests use), else
    ``init_method`` (``file://...`` or ``tcp://...``), else ``env://``.
    The backend is :func:`pick_backend`'s; it is printed (rank 0).  A
    group that fails to initialise raises, and a collective whose peers
    do not come within ``COLLECTIVE_TIMEOUT_S`` raises: no path carries
    on without the collectives."""
    import torch.distributed as dist

    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_ranks = int(env.get("LOCAL_WORLD_SIZE", world_size))
    backend = pick_backend(device_type, local_ranks)
    if device_type == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards < 1:
            raise RuntimeError("init_ranks on cuda: no card visible")
        device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    if dist.is_initialized():
        raise RuntimeError("this process already joined a process group")
    kw = {"backend": backend, "rank": rank, "world_size": world_size,
          "timeout": datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)}
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method or "env://"
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(**kw)
    if verbose and rank == 0:
        shared = (" (ranks share a card: gloo stages each collective "
                  "through the host)" if device_type == "cuda" and
                  backend == "gloo" else "")
        print(f"[mesh] {world_size} rank(s), backend {backend} on "
              f"{device_type}{shared}", flush=True)
    return backend, device


def elastic_mesh_shape(n_devices: int, model_parallel: int = 16):
    """(data, model) of :func:`make_elastic_mesh`: the model axis kept
    as wide as divides ``n_devices`` (halving from ``model_parallel``),
    the data axis the rest."""
    while model_parallel > 1 and n_devices % model_parallel != 0:
        model_parallel //= 2
    return n_devices // model_parallel, model_parallel


def _mesh(device_type: str, shape: Sequence[int], axes: Sequence[str]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n} ranks needs a process group: "
                           "init_ranks first")
    if n > dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the group "
                         f"has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).view(*shape),
                      mesh_dim_names=tuple(axes))


def make_elastic_mesh(n_devices: int, *, model_parallel: int = 16,
                      axis_names=("data", "model"),
                      device_type: str = "cuda"):
    """Degraded-capacity mesh after node failures: keeps the model axis
    intact (shard layout of the checkpoint) and shrinks the data axis."""
    return _mesh(device_type, elastic_mesh_shape(n_devices, model_parallel),
                 axis_names)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cpu"):
    """Small mesh over the group's first ranks (the CPU tests' gloo
    ranks)."""
    return _mesh(device_type, shape, axes)


class MeshAxis:
    """One axis of a mesh as this rank sees it: ``name``, its process
    ``group`` (``None``: the default group), ``size``, this rank's
    ``index`` on it, and its collectives, each counted in ``stats``
    (calls and bytes sent by kind, shared by a placement's axes).  An
    axis of size 1 runs no collective: every call returns its input."""

    def __init__(self, name: str, group, size: int, index: int,
                 stats: collections.Counter):
        self.name, self.group, self.size = name, group, int(size)
        self.index, self.stats = int(index), stats

    def note(self, kind: str, t: torch.Tensor):
        """Count one collective of ``kind`` over ``t``'s bytes."""
        self.stats[kind] += 1
        self.stats[kind + "_bytes"] += t.numel() * t.element_size()

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: ``x`` summed (``op="sum"``) or maxed (``"max"``)
        over the axis."""
        if self.size == 1:
            return x
        import torch.distributed as dist

        y = x.contiguous().clone()
        self.note("all_reduce", y)
        dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max" else
                        dist.ReduceOp.SUM, group=self.group)
        return y

    def all_gather(self, x: torch.Tensor, dim: int,
                   kind: str = "all_gather") -> torch.Tensor:
        """Every rank's ``x`` of the axis, joined along ``dim`` in index
        order (counted under ``kind``)."""
        if self.size == 1:
            return x
        import torch.distributed as dist

        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self.note(kind, x)
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` summed over the axis, this rank's ``1 / size`` slice
        along ``dim`` (the inverse of :meth:`all_gather`'s layout)."""
        if self.size == 1:
            return x
        import torch.distributed as dist

        xm = x.movedim(dim, 0).contiguous()
        out = xm.new_empty((xm.shape[0] // self.size, *xm.shape[1:]))
        self.note("reduce_scatter", xm)
        # the name changed in torch 2.13; the same call
        rs = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        rs(out, xm, group=self.group)
        return out.movedim(0, dim)

    def part(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's ``1 / size`` slice of ``x`` along ``dim`` (a view)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)

    def _peer(self, index: int) -> int:
        import torch.distributed as dist

        return (index if self.group is None else
                dist.get_global_rank(self.group, index))

    def send(self, x: torch.Tensor, index: int):
        """Send ``x`` to the rank at ``index`` on this axis (blocking).
        Over gloo a card tensor goes through the host, as gloo's own
        collectives stage it."""
        import torch.distributed as dist

        x = x.detach().contiguous()
        if x.is_cuda and dist.get_backend() == "gloo":
            x = x.cpu()
        self.note("send", x)
        dist.send(x, self._peer(index))

    def recv(self, like: torch.Tensor, index: int) -> torch.Tensor:
        """A tensor shaped and typed as ``like``, on its device, received
        from the rank at ``index`` on this axis (blocking)."""
        import torch.distributed as dist

        stage = like.is_cuda and dist.get_backend() == "gloo"
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if stage else like.device)
        dist.recv(buf, self._peer(index))
        return buf.to(like.device) if stage else buf


#: the axes a placement knows: ``pod`` (the pipeline's stages; beside
#: ``data`` the batch and the FSDP shards, beside ``model`` the decode
#: cache's sequence), ``data`` and ``model``
MESH_AXES = ("pod", "data", "model")


class MeshPlacement:
    """A rank's place on a ``(pod, data, model)`` mesh: ``names`` (the
    mesh's axes), ``sizes`` and ``coord`` ({axis: int}; an axis the mesh
    lacks has size 1), one :class:`MeshAxis` an axis (``pod``, ``data``,
    ``model``), ``world`` (every rank of the mesh), and ``stats``, the
    count of their collectives.  Two compound axes, each over process
    groups of its own: ``fsdp``, the ranks that share this rank's
    ``model`` coordinate (``(pod, data)``: the batch's rows and the FSDP
    shards), and ``seq``, those that share its ``data`` coordinate
    (``(pod, model)``: the decode cache's sequence).  A compound axis's
    index is row-major over its axes, pod first, the order in which a
    spec's tuple entry splits a dim (``runtime.sharding._block``); where
    one of its axes has size 1 it is the other axis itself, so a mesh
    without ``pod`` runs the collectives it ran before.  :meth:`over`
    gives the axis of any set of axes.  Every group is built here, in the
    same order on every rank.  Raises ``TypeError`` for what is not a
    ``DeviceMesh``, ``ValueError`` for a mesh that does not cover every
    rank of the default group (or whose ranks a compound axis needs in
    row-major order and are not), and ``NotImplementedError`` for an
    axis other than those."""

    def __init__(self, mesh):
        import torch.distributed as dist

        if not hasattr(mesh, "mesh_dim_names"):
            raise TypeError(f"a DeviceMesh with mesh_dim_names, not "
                            f"{type(mesh).__name__}")
        names = tuple(mesh.mesh_dim_names or ())
        extra = [a for a in names if a not in MESH_AXES]
        if extra:
            raise NotImplementedError(
                f"mesh axes {extra}: a placement knows {MESH_AXES} only")
        n = mesh.size()
        if n != dist.get_world_size():
            raise ValueError(f"a mesh of {n} ranks over a group of "
                             f"{dist.get_world_size()}: the model code "
                             "places over every rank of the group")
        self.mesh, self.names = mesh, names
        self.stats = collections.Counter()
        coord = mesh.get_coordinate()
        self.sizes = {a: 1 for a in MESH_AXES}
        self.coord = {a: 0 for a in MESH_AXES}
        self.axes = {}
        for i, a in enumerate(names):
            self.sizes[a], self.coord[a] = mesh.shape[i], coord[i]
        for a in MESH_AXES:
            group = mesh.get_group(a) if a in names else None
            self.axes[a] = MeshAxis(a, group, self.sizes[a], self.coord[a],
                                    self.stats)
        self.world = MeshAxis("world", None, n, dist.get_rank(), self.stats)
        # the rank grid with a dim an axis of MESH_AXES, in that order
        self._grid = mesh.mesh.permute(
            [names.index(a) for a in MESH_AXES if a in names]).reshape(
            [self.sizes[a] for a in MESH_AXES])
        self._over = {frozenset(c): self._compound(c)
                      for k in (2, 3) for c in
                      itertools.combinations(MESH_AXES, k)}

    def _compound(self, axes) -> MeshAxis:
        """The axis over ``axes`` (in MESH_AXES order): one of them where
        the others have size 1, ``world`` where they span every rank,
        else this rank's group of those that share its coordinates on the
        other axes (one ``new_group`` a coordinate, on every rank)."""
        import torch.distributed as dist

        live = [a for a in axes if self.sizes[a] > 1]
        if len(live) <= 1:
            return self.axes[live[0] if live else axes[-1]]
        rest = [a for a in MESH_AXES if a not in live]
        size = math.prod(self.sizes[a] for a in live)
        groups = self._grid.permute(
            [MESH_AXES.index(a) for a in rest + live]).reshape(
            -1, size).tolist()
        if any(g != sorted(g) for g in groups):
            raise ValueError(
                f"the ranks of {self.names} = {tuple(self.mesh.shape)} are "
                f"not in row-major order over {tuple(live)}: a group's "
                "index would not be its ranks' order")
        index = 0
        for a in live:
            index = index * self.sizes[a] + self.coord[a]
        if len(groups) == 1:
            return self.world
        me, mine = dist.get_rank(), None
        for ranks in groups:
            group = dist.new_group(ranks)
            if me in ranks:
                mine = group
        return MeshAxis(",".join(live), mine, size, index, self.stats)

    @property
    def pod(self) -> MeshAxis:
        return self.axes["pod"]

    @property
    def data(self) -> MeshAxis:
        return self.axes["data"]

    @property
    def model(self) -> MeshAxis:
        return self.axes["model"]

    @property
    def fsdp(self) -> MeshAxis:
        """``(pod, data)``: the batch's rows and the FSDP shards."""
        return self._over[frozenset(("pod", "data"))]

    @property
    def seq(self) -> MeshAxis:
        """``(pod, model)``: the decode cache's sequence."""
        return self._over[frozenset(("pod", "model"))]

    def over(self, axes) -> Optional[MeshAxis]:
        """The axis spanning ``axes`` (names): one of them, a compound
        axis for two (``fsdp``, ``seq``, or ``(data, model)``: the ranks
        of one pod), ``world`` for the three, ``None`` for none."""
        axes = frozenset(axes)
        if not axes:
            return None
        if len(axes) == 1:
            return self.axes[next(iter(axes))]
        return self._over[axes]

    def rows_axis(self, n: int, axes=("pod", "data")) -> Optional[MeshAxis]:
        """The axis over which ``n`` rows split: the largest prefix of
        ``axes`` whose product divides ``n`` (the reference's
        ``axes_if_div``: a batch that does not divide over ``(pod, data)``
        splits over ``pod`` alone), ``None`` where none does (every rank
        holds every row; an axis of size 1 is left out)."""
        axes = [a for a in axes if self.sizes[a] > 1]
        while axes:
            if n % math.prod(self.sizes[a] for a in axes) == 0:
                return self.over(axes)
            axes.pop()
        return None


def _rank_main(rank: int, n: int, device_type: str, workdir: str):
    import torch.distributed as dist

    # one thread a rank: the ranks share the host's cores
    torch.set_num_threads(1)
    fn, args = torch.load(os.path.join(workdir, "call.pt"),
                          weights_only=False)
    store = dist.FileStore(os.path.join(workdir, "store"), n)
    init_ranks(device_type, rank=rank, world_size=n, store=store,
               verbose=False)
    try:
        # every rank joined before any runs: a rank that raises at once
        # would otherwise close its connections under a peer still
        # setting its own up, and the peer's error would be reported
        dist.barrier()
        out = fn(*args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        # no rank tears its connections down while a peer still reads
        dist.barrier()
    finally:
        dist.destroy_process_group()
    # the result is saved and the group gone: leave without the exit
    # handlers, where a transport thread torn down late can abort a
    # process that has finished its work (seen once on a loaded host)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_ranks(fn: Callable, n: int, args: tuple = (), *,
              device_type: str = "cpu", timeout_s: float = 300.0,
              workdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``n`` fresh processes joined as ranks 0..n-1
    of one process group (:func:`init_ranks` with a ``FileStore`` in
    ``workdir``; one intra-op thread a rank), and return each rank's return value (through
    ``torch.save``), rank order.  ``fn`` must be importable (a module's
    top-level function).  A rank that raises ends the others and raises
    here; ranks that have not all ended within ``timeout_s`` are killed
    and ``TimeoutError`` is raised."""
    import torch.multiprocessing as mp

    own = workdir is None
    tmp = tempfile.TemporaryDirectory() if own else None
    wd = tmp.name if own else workdir
    os.makedirs(wd, exist_ok=True)
    try:
        # the call goes through a file: arguments written down a spawned
        # process's pipe past its buffer block the parent until that
        # process has started, so the ranks would start one at a time
        torch.save((fn, tuple(args)), os.path.join(wd, "call.pt"))
        ctx = mp.start_processes(
            _rank_main, args=(n, device_type, wd),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{n} ranks of {fn.__name__} did not end "
                                   f"within {timeout_s:.0f} s")
        return [torch.load(os.path.join(wd, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        if tmp is not None:
            tmp.cleanup()
