"""Wrapper of the hand-written RWKV6 wkv-scan CUDA kernel.

``csrc/rwkv_scan.cu`` replaces the JAX package's Pallas TPU kernel
``_wkv_kernel`` (``repro/kernels/rwkv_scan.py:21``).  As in
``kernels.paged_attention``: the wrapper checks its inputs and raises on
what the kernel does not take, allocates the outputs with
``torch.empty``, launches on the current CUDA stream and raises if the
launcher returns a CUDA error.  For tensors on the CPU (and only there)
it runs the plain version ``ref.wkv_chunked_ref``.  ``LAUNCHES`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"rwkv_scan_f32": 0}

MAX_CHUNK = 64


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load_library("rwkv_scan")
    lib.rwkv_scan_f32.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                                  + [ctypes.c_void_p])
    lib.rwkv_scan_f32.restype = ctypes.c_int
    return lib


def _check(r, k, v, logw, u, s0, chunk):
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"r/k/logw must be [B, S, H, dk] and v [B, S, H, "
                         f"dv]; got {tuple(r.shape)} and {tuple(v.shape)}")
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    if k.shape != r.shape or logw.shape != r.shape or \
            tuple(v.shape[:3]) != (b, s, h):
        raise ValueError("r, k, logw and v disagree on [B, S, H]")
    if tuple(u.shape) != (h, dk) or tuple(s0.shape) != (b, h, dk, dv):
        raise ValueError(f"u must be [{h}, {dk}] and s0 [{b}, {h}, {dk}, "
                         f"{dv}]; got {tuple(u.shape)} and {tuple(s0.shape)}")
    for t in (r, k, v, logw, u, s0):
        if t.dtype != torch.float32:
            raise TypeError(f"inputs must be float32, got {t.dtype}")
    ck = min(chunk, s)
    if ck < 1 or s % ck:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {ck}")
    return b, s, h, dk, dv, ck


def rwkv_scan(r, k, v, logw, u, s0, chunk: int = 32):
    """RWKV6 wkv recurrence over chunks of ``min(chunk, S)`` tokens.

    r/k/logw: [B, S, H, dk]; v: [B, S, H, dv]; u: [H, dk]; s0:
    [B, H, dk, dv]; all f32, logw <= 0.  Returns (o [B, S, H, dv],
    sT [B, H, dk, dv]).  S must be a multiple of the chunk.
    """
    b, s, h, dk, dv, ck = _check(r, k, v, logw, u, s0, chunk)
    if r.device.type == "cpu":
        return ref.wkv_chunked_ref(r, k, v, logw, u, s0, chunk=ck)
    for t in (k, v, logw, u, s0):
        if t.device != r.device:
            raise ValueError(f"all inputs must be on {r.device}; one is on "
                             f"{t.device}")
    if ck > MAX_CHUNK:
        raise ValueError(f"chunk {ck} > {MAX_CHUNK}")
    if dk % 4 or dv % 4:
        raise ValueError(f"dk={dk} and dv={dv} must be multiples of 4")
    tensors = (r, k, v, logw, u, s0)
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the CUDA kernel takes contiguous inputs that "
                             "start 16-byte aligned")
    o = torch.empty_like(v)
    s_t = torch.empty_like(s0)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _lib().rwkv_scan_f32(*(t.data_ptr() for t in tensors),
                               o.data_ptr(), s_t.data_ptr(), b, s, h, dk,
                               dv, ck, stream)
    if err != 0:
        raise RuntimeError(f"rwkv_scan_f32 launch failed: cudaError_t {err}")
    LAUNCHES["rwkv_scan_f32"] += 1
    return o, s_t
