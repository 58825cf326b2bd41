"""Wrappers of the hand-written embedding-bag and row-gather CUDA kernels.

``csrc/embed_agg.cu`` replaces the JAX package's Pallas TPU kernels
``_embed_kernel`` and ``_gather_kernel`` (``repro/kernels/embed_agg.py:23,
:94``).  As in ``kernels.isp_scan``: each wrapper checks its inputs,
allocates the output with ``torch.empty``, launches on the current CUDA
stream and raises on a CUDA error; tensors on the CPU (and only there)
run the plain version in ``kernels.ref``.  ``LAUNCHES`` counts launches.
The kernels' split of a row is ``ref.embed_plan``, which this wrapper
passes to the kernel and the CPU emulations follow.

Indices are checked eagerly (:func:`validate_embed_args`): one fused
min/max transfer per call, the only device-to-host sync of these calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"embed_agg": 0, "embed_gather": 0}

#: table dtypes of the bag kernel, in the order of ``enum Code`` in
#: ``csrc/embed_agg.cu``: every code widens to f32 as ``Tensor.float``
#: widens it
AGG_DTYPES = (torch.float32, torch.bfloat16, torch.float16,
              torch.float8_e4m3fn, torch.float8_e5m2, torch.int8,
              torch.uint8, torch.int16, torch.int32)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    # table, ld, code, ids, weights (NULL: unweighted), out, B, L, D,
    # vec, lanes, slices, blocks, stream
    "embed_agg": [_P, _LL, _I, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _P],
    # table, ld, ids, out, rows, row bytes, vec, lanes, slices, blocks,
    # stream
    "embed_gather": [_P, _LL, _P, _P, _LL, _LL, _I, _I, _I, _I, _P],
    "embed_floor_empty": [_I, _P],
    # table, ld, ids, L, groups, row bytes, lanes, slices, blocks, sink,
    # stream
    "embed_floor_pair": [_P, _LL, _P, _I, _LL, _LL, _I, _I, _I, _P, _P],
}


@functools.lru_cache(maxsize=None)
def _bind(name: str):
    fn = getattr(build.load_library("embed_agg"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def validate_embed_args(table, indices):
    """Reject malformed lookups before any kernel runs: indices must be
    [B, L] of an integer dtype (``TypeError`` otherwise) with every id
    in [0, V) (``ValueError``), checked with one fused min/max transfer.
    The kernels would read out of bounds instead."""
    if indices.dim() != 2:
        raise ValueError(f"indices must be [B, L], got shape "
                         f"{tuple(indices.shape)}")
    if indices.dtype.is_floating_point or indices.dtype.is_complex or \
            indices.dtype == torch.bool:
        raise TypeError(f"indices must be an integer dtype (int32), got "
                        f"{indices.dtype}")
    v = table.shape[0]
    lo, hi = torch.stack([indices.min(), indices.max()]).tolist()
    if lo < 0 or hi >= v:
        raise ValueError(
            f"embedding indices out of range: min={lo} max={hi} but "
            f"vocab size is {v} (valid ids are [0, {v - 1}])")


def kernel_takes(table, weights=None, *, gather: bool = False) -> str:
    """The kernel that takes this table, as ``csrc/embed_agg.cu`` picks
    it: ``"<dtype>_v<piece bytes>"`` for the bag, ``"gather_v<piece
    bytes>"`` for the gather (``ref.embed_plan``).  The bag takes tables
    of ``AGG_DTYPES`` and weights of any real dtype (widened to f32 as
    the plain version widens them); the gather rows of any dtype (a
    copy of their bytes).
    Raises only where no kernel can read the table: not [V, D], a row
    whose elements are not adjacent, a pointer not aligned to its
    element (``ValueError``), or a bag table dtype that does not widen
    to f32 (``TypeError``)."""
    if table.dim() != 2:
        raise ValueError(f"the table must be [V, D], got shape "
                         f"{tuple(table.shape)}")
    if table.stride(1) != 1:
        raise ValueError("the kernels read a table whose rows are "
                         "contiguous (stride(1) == 1)")
    if table.data_ptr() % table.element_size():
        raise ValueError("the table's pointer is not aligned to its "
                         "element")
    if not gather and table.dtype not in AGG_DTYPES:
        raise TypeError(f"the bag kernel takes tables of "
                        f"{[str(t) for t in AGG_DTYPES]}, got {table.dtype}")
    if weights is not None and weights.dtype.is_complex:
        raise TypeError(f"weights must be real numbers, got {weights.dtype}")
    vec = plan_of(table).vec
    name = "gather" if gather else str(table.dtype).replace("torch.", "")
    return f"{name}_v{vec}"


def plan_of(table) -> ref.EmbedPlan:
    """``ref.embed_plan`` for this [V, D] table: its element size, D and
    the alignment of its rows."""
    return ref.embed_plan(table.element_size(), table.shape[1],
                          ref.embed_align(table))


def _cuda_inputs(table, indices, *extra):
    dev = table.device
    for t in (indices, *extra):
        if t is not None and t.device != dev:
            raise ValueError(f"all inputs must be on {dev}; one is on "
                             f"{t.device}")
    # ids are < V < 2^31 (validated): int32 is what the kernel reads
    return indices.to(torch.int32).contiguous()


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def embed_agg(table, indices, weights=None):
    """Sum-pooled embedding lookups.

    table: [V, D] of ``AGG_DTYPES``; indices: [B, L] integer; weights:
    optional [B, L] of a real dtype.  Returns [B, D] f32, each bag
    summed in lookup order from 0 (``acc + w * row``, codes and weights
    widened to f32, the product rounded first).  Bit-identical to
    ``ref.embed_agg_ref``.
    """
    validate_embed_args(table, indices)
    b, n_look = indices.shape
    if weights is not None and tuple(weights.shape) != (b, n_look):
        raise ValueError(f"weights must be [{b}, {n_look}], got "
                         f"{tuple(weights.shape)}")
    if table.device.type == "cpu":
        return ref.embed_agg_ref(table, indices, weights)
    return launch_embed_agg(table, _cuda_inputs(table, indices, weights),
                            weights)


def launch_embed_agg(table, idx, weights=None):
    """The CUDA launch of :func:`embed_agg` on ids already validated
    (``idx`` int32 contiguous on the table's device): no check of the
    ids, no sync."""
    kernel_takes(table, weights)
    plan = plan_of(table)
    if weights is not None:
        weights = weights.float().contiguous()
    b, n_look = idx.shape
    d = table.shape[1]
    out = torch.empty((b, d), device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _bind("embed_agg")(
        table.data_ptr(), table.stride(0) * table.element_size(),
        AGG_DTYPES.index(table.dtype), idx.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        b, n_look, d, plan.vec, plan.lanes, plan.slices,
        ref.embed_blocks(plan, b), stream)
    _raise_on(err, "embed_agg")
    LAUNCHES["embed_agg"] += 1
    return out


def embed_gather(table, indices):
    """Batched row gather: table [V, D] of any dtype by indices [B, K]
    -> [B, K, D] of the table's dtype, in one launch."""
    validate_embed_args(table, indices)
    if table.device.type == "cpu":
        return ref.embed_gather_ref(table, indices)
    return launch_embed_gather(table, _cuda_inputs(table, indices))


def launch_embed_gather(table, idx):
    """The CUDA launch of :func:`embed_gather` on ids already validated
    (``idx`` int32 contiguous on the table's device): no check of the
    ids, no sync."""
    kernel_takes(table, gather=True)
    plan = plan_of(table)
    b, kk = idx.shape
    d = table.shape[1]
    out = torch.empty((b, kk, d), dtype=table.dtype, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    es = table.element_size()
    err = _bind("embed_gather")(
        table.data_ptr(), table.stride(0) * es, idx.data_ptr(),
        out.data_ptr(), b * kk, d * es, plan.vec, plan.lanes, plan.slices,
        ref.embed_blocks(plan, b * kk), stream)
    _raise_on(err, "embed_gather")
    LAUNCHES["embed_gather"] += 1
    return out


def floor_runners(table, idx):
    """Two callables that time the floors of a call over ``table`` and
    ``idx`` (validated int32 ids on the card: a bag call's [B, L], or a
    gather's ids as [B * K, 1], a bag of one a row): the empty
    kernel on the call's grid, and the dependent pair (each group loads
    its first id, then a 16-byte piece of that row).  Card only; rows of
    16-byte pieces only; not counted in ``LAUNCHES``."""
    if table.device.type != "cuda":
        raise ValueError("floor_runners times kernels on the card")
    kernel_takes(table, gather=True)
    plan = plan_of(table)
    if plan.vec != 16:
        raise ValueError("the pair probe reads 16-byte pieces")
    b, n_look = idx.shape
    blocks = ref.embed_blocks(plan, b)
    es = table.element_size()
    sink = torch.zeros(1, dtype=torch.int32, device=table.device)

    def stream():
        return torch.cuda.current_stream(table.device).cuda_stream

    def empty():
        _raise_on(_bind("embed_floor_empty")(blocks, stream()),
                  "embed_floor_empty")

    def pair():
        _raise_on(_bind("embed_floor_pair")(
            table.data_ptr(), table.stride(0) * es, idx.data_ptr(), n_look,
            b * plan.slices, table.shape[1] * es, plan.lanes, plan.slices,
            blocks, sink.data_ptr(), stream()), "embed_floor_pair")
    return empty, pair
