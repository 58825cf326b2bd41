"""Wrappers of the hand-written paged-attention CUDA kernels.

``csrc/paged_attention.cu`` replaces the JAX package's Pallas TPU
kernels ``_paged_kernel`` and ``_paged_q8_kernel``
(``repro/kernels/paged_attention.py:39, :77``).  Each wrapper checks
device, dtype, shape and contiguity and raises on what the kernel does
not take, allocates the output with ``torch.empty``, launches on the
current CUDA stream and raises if the launcher returns a CUDA error.
For tensors on the CPU (and only there) it runs the plain version in
``kernels.ref`` instead.  ``LAUNCHES`` counts kernel launches, one entry
per compiled kernel; nothing else adds to it.

Page ids are trusted: the table's entries below ``ceil(length/page)``
must name pages of ``k_pages`` (the serving path's ``PageTableManager``
guarantees it); checking them would cost a device-to-host sync per call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"paged_attention_f32": 0, "paged_attention_q8_int8": 0,
            "paged_attention_q8_fp8": 0}

_CODE_KERNEL = {torch.int8: "paged_attention_q8_int8",
                torch.float8_e4m3fn: "paged_attention_q8_fp8"}

MAX_PAGE = 64
MAX_GROUP = 32


@functools.lru_cache(maxsize=None)
def _bind(name: str, n_pointers: int):
    fn = getattr(build.load_library("paged_attention"), name)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 6 +
                   [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, page_table, lengths, code_dtypes):
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be [B, H, D] and pages [P, page, Hkv, D]; "
                         f"got {tuple(q.shape)} and {tuple(k_pages.shape)}")
    b, h, d = q.shape
    n_phys, page, hkv, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError(f"k/v pages {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not match q's D={d}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be [B={b}, pps]; "
                         f"got {tuple(page_table.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [B={b}]; got {tuple(lengths.shape)}")
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if k_pages.dtype not in code_dtypes or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pages must be one of {code_dtypes}, got "
                        f"{k_pages.dtype}/{v_pages.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    return b, h, d, n_phys, page, hkv


def _check_cuda(tensors, b, h, d, page, hkv, pps):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}; one is on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous inputs only")
    if any(t.data_ptr() % 16 for t in tensors[1:3]):
        raise ValueError("the page tensors must start 16-byte aligned "
                         "(the kernel reads them in 16-byte vectors)")
    if d % 32 or d > 256:
        raise ValueError(f"head_dim {d} must be a multiple of 32 up to 256")
    if page > MAX_PAGE:
        raise ValueError(f"page size {page} > {MAX_PAGE}")
    if h // hkv > MAX_GROUP:
        raise ValueError(f"GQA group {h // hkv} > {MAX_GROUP}")
    if b < 1 or pps < 1:
        raise ValueError("empty batch or page table")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def paged_attention(q, k_pages, v_pages, page_table, lengths):
    """GQA decode attention over a paged KV pool.

    q: [B, H, D] f32; k_pages/v_pages: [P, page, Hkv, D] f32;
    page_table: [B, pps] int32 physical ids; lengths: [B] int32 valid
    positions (0 = padding row, returns zeros).  Returns [B, H, D] f32.
    """
    b, h, d, _, page, hkv = _check(q, k_pages, v_pages, page_table,
                                   lengths, (torch.float32,))
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, page_table,
                                       lengths)
    pps = page_table.shape[1]
    _check_cuda((q, k_pages, v_pages, page_table, lengths), b, h, d, page,
                hkv, pps)
    out = torch.empty_like(q)
    fn = _bind("paged_attention_f32", 6)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             b, h, hkv, d, pps, page, stream)
    _raise_on(err, "paged_attention_f32")
    LAUNCHES["paged_attention_f32"] += 1
    return out


def paged_attention_q8(q, k_pages, v_pages, k_scale, v_scale, page_table,
                       lengths):
    """The same attention over int8 or fp8-e4m3 codes.

    k_pages/v_pages: [P, page, Hkv, D] ``torch.int8`` or
    ``torch.float8_e4m3fn``; k_scale/v_scale: [P, page, Hkv] f32
    per-slot scales.  The k scale multiplies the logits and the v scale
    the probabilities; no f32 page is materialised on the card.
    """
    b, h, d, n_phys, page, hkv = _check(q, k_pages, v_pages, page_table,
                                        lengths, tuple(_CODE_KERNEL))
    sshape = (n_phys, page, hkv)
    if tuple(k_scale.shape) != sshape or tuple(v_scale.shape) != sshape:
        raise ValueError(f"scales must be {sshape}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("scales must be float32")
    if q.device.type == "cpu":
        return ref.paged_attention_q8_ref(q, k_pages, v_pages, k_scale,
                                          v_scale, page_table, lengths)
    pps = page_table.shape[1]
    _check_cuda((q, k_pages, v_pages, k_scale, v_scale, page_table, lengths),
                b, h, d, page, hkv, pps)
    out = torch.empty_like(q)
    name = _CODE_KERNEL[k_pages.dtype]
    fn = _bind(name, 8)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # fp8 codes: the bytes are handed over as-is and read as __nv_fp8_e4m3
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), b, h, hkv, d, pps, page,
             stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out
