"""Wrappers of the hand-written embedding-bag and row-gather CUDA kernels.

``csrc/embed_agg.cu`` replaces the JAX package's Pallas TPU kernels
``_embed_kernel`` and ``_gather_kernel`` (``repro/kernels/embed_agg.py:23,
:94``).  As in ``kernels.isp_scan``: each wrapper checks its inputs,
allocates the output with ``torch.empty``, launches on the current CUDA
stream and raises on a CUDA error; tensors on the CPU (and only there)
run the plain version in ``kernels.ref``.  ``LAUNCHES`` counts launches.

Indices are checked eagerly (:func:`validate_embed_args`): one fused
min/max transfer per call, the only device-to-host sync of these calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"embed_agg": 0, "embed_gather": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_GATHER = {torch.float32: "embed_gather_f32", torch.int32: "embed_gather_i32"}


@functools.lru_cache(maxsize=None)
def _bind(name: str):
    fn = getattr(build.load_library("embed_agg"), name)
    if name == "embed_agg":
        # table, indices, weights (NULL = unweighted), out, B, L, D, stream
        fn.argtypes = [_P] * 4 + [_I, _I, _I, _P]
    else:
        # table, indices, out, B*K, D, stream
        fn.argtypes = [_P] * 3 + [_LL, _I, _P]
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


def _cuda_inputs(table, indices, *extra):
    dev = table.device
    for t in (indices, *extra):
        if t is not None and t.device != dev:
            raise ValueError(f"all inputs must be on {dev}; one is on "
                             f"{t.device}")
    if not table.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous table only")
    # ids are < V < 2^31 (validated): int32 is what the kernel reads
    return indices.to(torch.int32).contiguous()


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def embed_agg(table, indices, weights=None):
    """Sum-pooled embedding lookups.

    table: [V, D] f32; indices: [B, L] integer; weights: optional [B, L]
    f32.  Returns [B, D] f32, each bag summed in lookup order from 0
    (``acc + w * row``, the product rounded first).  Bit-identical to
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
    (``idx`` int32 contiguous on the table's device): no check, no
    sync."""
    if table.dtype != torch.float32 or table.dim() != 2:
        raise TypeError("the CUDA kernel takes a [V, D] float32 table")
    if weights is not None:
        if weights.dtype != torch.float32:
            raise TypeError("weights must be float32")
        weights = weights.contiguous()
    b, n_look = idx.shape
    d = table.shape[1]
    out = torch.empty((b, d), device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _bind("embed_agg")(table.data_ptr(), idx.data_ptr(),
                             None if weights is None else weights.data_ptr(),
                             out.data_ptr(), b, n_look, d, stream)
    _raise_on(err, "embed_agg")
    LAUNCHES["embed_agg"] += 1
    return out


def embed_gather(table, indices):
    """Batched row gather: table [V, D] (f32 or int32) by indices [B, K]
    -> [B, K, D] of the table's dtype, in one launch."""
    validate_embed_args(table, indices)
    if table.device.type == "cpu":
        return ref.embed_gather_ref(table, indices)
    return launch_embed_gather(table, _cuda_inputs(table, indices))


def launch_embed_gather(table, idx):
    """The CUDA launch of :func:`embed_gather` on ids already validated
    (``idx`` int32 contiguous on the table's device): no check, no
    sync."""
    if table.dtype not in _GATHER or table.dim() != 2:
        raise TypeError(f"the CUDA kernel takes a [V, D] table of "
                        f"{tuple(_GATHER)}, got {table.dtype}")
    b, kk = idx.shape
    d = table.shape[1]
    out = torch.empty((b, kk, d), dtype=table.dtype, device=table.device)
    name = _GATHER[table.dtype]
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _bind(name)(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                      b * kk, d, stream)
    _raise_on(err, name)
    LAUNCHES["embed_gather"] += 1
    return out
