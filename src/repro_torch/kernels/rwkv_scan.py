"""Wrapper of the hand-written RWKV6 wkv-scan CUDA kernel.

``csrc/rwkv_scan.cu`` replaces the JAX package's Pallas TPU kernel
``_wkv_kernel`` (``repro/kernels/rwkv_scan.py:21``).  As in
``kernels.paged_attention``: the wrapper checks its inputs and raises on
what the kernel does not take, allocates the outputs with
``torch.empty``, launches on the current CUDA stream and raises if the
launcher returns a CUDA error.  For tensors on the CPU (and only there)
it runs the plain version ``ref.wkv_chunked_ref``.  ``LAUNCHES`` counts
kernel launches.

Training: :func:`rwkv_scan_states` is the same kernel also writing the
state at the start of every step of ``ref.wkv_step_tokens(chunk)``
tokens, and :func:`rwkv_scan_bwd` launches the backward kernels of
``csrc/rwkv_scan_bwd.cu`` from those states (the JAX package takes this
gradient by autodiff of its plain ``wkv_chunked``; there is no Pallas
backward): a state pass, a chunk pass over every step at once and du's
ordered sum, one launcher call counted once.  :class:`WkvScanFn` ties the two together under autograd; on
CPU tensors they run ``ref.wkv_chunked_ref``, ``ref.wkv_states_ref`` and
``ref.wkv_chunked_bwd_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"rwkv_scan_f32": 0, "rwkv_scan_states_f32": 0,
            "rwkv_scan_bwd_f32": 0}

MAX_CHUNK = 64


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load_library("rwkv_scan")
    lib.rwkv_scan_f32.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                                  + [ctypes.c_void_p])
    lib.rwkv_scan_f32.restype = ctypes.c_int
    lib.rwkv_scan_states_f32.argtypes = ([ctypes.c_void_p] * 9 +
                                         [ctypes.c_int] * 6 +
                                         [ctypes.c_void_p])
    lib.rwkv_scan_states_f32.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd():
    fn = build.load_library("rwkv_scan_bwd").rwkv_scan_bwd_f32
    # r k v logw u states do dsT dr dk dv dlogw du ds0 gs ws, B S H dk dv
    # step, stream
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    # float64 only on the CPU (the plain versions, for gradient checks)
    for t in (r, k, v, logw, u, s0):
        if t.dtype not in (torch.float32, torch.float64) or \
                t.dtype != r.dtype:
            raise TypeError(f"inputs must be float32 (or all float64 on "
                            f"the CPU), got {t.dtype}")
    ck = min(chunk, s)
    if ck < 1 or s % ck:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {ck}")
    return b, s, h, dk, dv, ck


def _check_card(r, tensors, ck, dk, dv):
    if r.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {r.dtype}")
    for t in tensors:
        if t.device != r.device:
            raise ValueError(f"all inputs must be on {r.device}; one is on "
                             f"{t.device}")
    if ck > MAX_CHUNK:
        raise ValueError(f"chunk {ck} > {MAX_CHUNK}")
    if dk % 4 or dv % 4:
        raise ValueError(f"dk={dk} and dv={dv} must be multiples of 4")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the CUDA kernel takes contiguous inputs that "
                             "start 16-byte aligned")


def _forward(r, k, v, logw, u, s0, chunk, states: bool):
    """Launch the forward kernel (``rwkv_scan_states_f32`` with
    ``states``): (o, sT) or (o, sT, states); the plain versions on the
    CPU."""
    b, s, h, dk, dv, ck = _check(r, k, v, logw, u, s0, chunk)
    step = ref.wkv_step_tokens(ck)
    if r.device.type == "cpu":
        o, s_t = ref.wkv_chunked_ref(r, k, v, logw, u, s0, chunk=ck)
        return ((o, s_t, ref.wkv_states_ref(k, v, logw, s0, step)) if states
                else (o, s_t))
    tensors = (r, k, v, logw, u, s0)
    _check_card(r, tensors, ck, dk, dv)
    out = [torch.empty_like(v), torch.empty_like(s0)]
    if states:
        out.append(torch.empty((b, h, s // step, dk, dv),
                               dtype=torch.float32, device=r.device))
    name = "rwkv_scan_states_f32" if states else "rwkv_scan_f32"
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = getattr(_lib(), name)(*(t.data_ptr() for t in (*tensors, *out)),
                                b, s, h, dk, dv, ck, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1
    return tuple(out)


def rwkv_scan(r, k, v, logw, u, s0, chunk: int = 32):
    """RWKV6 wkv recurrence over chunks of ``min(chunk, S)`` tokens.

    r/k/logw: [B, S, H, dk]; v: [B, S, H, dv]; u: [H, dk]; s0:
    [B, H, dk, dv]; all f32, logw <= 0.  Returns (o [B, S, H, dv],
    sT [B, H, dk, dv]).  S must be a multiple of the chunk.  On the CPU
    the inputs may all be float64 (the plain version in float64).
    """
    return _forward(r, k, v, logw, u, s0, chunk, states=False)


def rwkv_scan_states(r, k, v, logw, u, s0, chunk: int = 32):
    """:func:`rwkv_scan` that also returns the state at the start of every
    step of ``ref.wkv_step_tokens(min(chunk, S))`` tokens: (o, sT,
    states [B, H, S / step, dk, dv]), entry 0 being ``s0``; o and sT are
    :func:`rwkv_scan`'s, bit for bit (what the backward starts from)."""
    return _forward(r, k, v, logw, u, s0, chunk, states=True)


def rwkv_scan_bwd(r, k, v, logw, u, s0, states, s_t, do, dsT,
                  chunk: int = 32):
    """Gradient of :func:`rwkv_scan` with respect to r, k, v, logw, u and
    s0, from the forward's ``states`` and ``s_t`` (:func:`rwkv_scan_states`)
    and the outputs' gradients ``do`` [B, S, H, dv] and ``dsT`` [B, H, dk,
    dv].  Returns (dr, dk, dv, dlogw, du [H, dk], ds0), f32;
    deterministic (du's step and batch shares summed in order, no float
    atomics).  ``s_t`` is checked but not read on the card: each step's
    end state enters only through rowsum(S_end * G), which the kernel
    takes from the step's start state.  Scratch: the gradient of the
    state after every step (as large as ``states``) and the du shares,
    freed after the call.  On CPU tensors the plain
    ``ref.wkv_chunked_bwd_ref``, which recomputes the states itself."""
    b, s, h, dk, dv, ck = _check(r, k, v, logw, u, s0, chunk)
    if do.shape != v.shape or tuple(dsT.shape) != (b, h, dk, dv) or \
            tuple(s_t.shape) != (b, h, dk, dv):
        raise ValueError(f"do must be shaped as v {tuple(v.shape)}, dsT and "
                         f"s_t as s0; got {tuple(do.shape)}, "
                         f"{tuple(dsT.shape)}, {tuple(s_t.shape)}")
    for t in (do, dsT, s_t):
        if t.dtype != r.dtype:
            raise TypeError(f"do/dsT/s_t must be {r.dtype}, got {t.dtype}")
    if r.device.type == "cpu":
        return ref.wkv_chunked_bwd_ref(r, k, v, logw, u, s0, do, dsT,
                                       chunk=ck)
    step = ref.wkv_step_tokens(ck)
    if states is None or tuple(states.shape) != (b, h, s // step, dk, dv) \
            or states.dtype != torch.float32:
        raise ValueError(f"states must be f32 [B, H, S / step, dk, dv] = "
                         f"{(b, h, s // step, dk, dv)} (rwkv_scan_states)")
    tensors = (r, k, v, logw, u, states, do, dsT)
    _check_card(r, (*tensors, s_t), ck, dk, dv)
    if b * h * (s // step) > 2 ** 31 - 1:
        raise ValueError("B * H * S / step must fit the grid")
    grads = [torch.empty_like(x) for x in (r, k, v, logw, u, s0)]
    gs = torch.empty_like(states)
    ws = torch.empty((b, h, s // step, dk), dtype=torch.float32,
                     device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _bwd()(*(t.data_ptr() for t in (*tensors, *grads, gs, ws)),
                 b, s, h, dk, dv, step, stream)
    if err != 0:
        raise RuntimeError(f"rwkv_scan_bwd_f32 launch failed: cudaError_t "
                           f"{err}")
    LAUNCHES["rwkv_scan_bwd_f32"] += 1
    return tuple(grads)


class WkvScanFn(torch.autograd.Function):
    """The wkv scan with its gradient: the forward launches
    :func:`rwkv_scan_states` and saves its inputs, ``sT`` and the step
    states; the backward launches :func:`rwkv_scan_bwd`.  Gradients flow
    to r, k, v, logw, u and s0.  Under ``torch.utils.checkpoint`` the
    forward runs twice a step (each run counted)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0, chunk):
        o, s_t, states = rwkv_scan_states(r, k, v, logw, u, s0, chunk)
        ctx.save_for_backward(r, k, v, logw, u, s0, states, s_t)
        ctx.chunk = chunk
        return o, s_t

    @staticmethod
    def backward(ctx, do, dsT):
        r, k, v, logw, u, s0, states, s_t = ctx.saved_tensors
        grads = rwkv_scan_bwd(r, k, v, logw, u, s0, states, s_t,
                              do.contiguous(), dsT.contiguous(), ctx.chunk)
        return (*grads, None)


def rwkv_scan_with_grad(r, k, v, logw, u, s0, chunk: int = 32):
    """:func:`rwkv_scan` under autograd (:class:`WkvScanFn`); same
    arguments and results.  Inputs are made contiguous."""
    return WkvScanFn.apply(*(t.contiguous() for t in (r, k, v, logw, u, s0)),
                           chunk)
