"""Wrapper of the hand-written flash-attention CUDA kernel.

``csrc/flash_attention.cu`` replaces the JAX package's Pallas TPU kernel
``_flash_kernel`` (``repro/kernels/flash_attention.py:26``); its
products run on the tensor cores as 3xTF32 (f32 accuracy, see
``ref.flash_attention_3xtf32``).  As in
``kernels.paged_attention``: the wrapper checks device, dtype, shape,
contiguity and alignment and raises on what the kernel does not take,
allocates the output with ``torch.empty``, launches on the current CUDA
stream and raises if the launcher returns a CUDA error.  For tensors on
the CPU (and only there) it runs the plain version
``ref.flash_attention_ref``.  ``LAUNCHES`` counts kernel launches.

Training: :func:`flash_attention_lse` is the same kernel also writing
each row's logsumexp, and :func:`flash_attention_bwd` launches the
backward kernels of ``csrc/flash_attention_bwd.cu`` (the JAX package
takes this gradient by autodiff of ``chunked_attention``; there is no
Pallas backward).  :class:`FlashAttentionFn` ties the two together under
autograd; on CPU tensors they run ``ref.flash_attention_lse_ref`` and
``ref.flash_attention_bwd_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.scratch import merge_tickets

LAUNCHES = {"flash_attention_f32": 0, "flash_attention_fwd_lse_f32": 0,
            "flash_attention_bwd_f32": 0}

MAX_HEAD_DIM = 256
MAX_GROUP = 64


def kernel_takes(head_dim: int, group: int) -> bool:
    """Whether the CUDA kernel takes this head_dim and GQA group: D a
    multiple of 8 in [8, 256] (one instantiation a multiple of 32, the
    columns past D zero-filled) and G = H / Hkv in [1, 64] (a block's 64
    rows are the G heads of one kv head)."""
    return (head_dim % 8 == 0 and 8 <= head_dim <= MAX_HEAD_DIM and
            1 <= group <= MAX_GROUP)


#: keys of the kernel's K/V tiles (the plain 3xTF32 emulation
#: ``ref.flash_attention_3xtf32`` walks the same tiles)
KEY_TILE = 32


@functools.lru_cache(maxsize=None)
def _bind():
    fn = build.load_library("flash_attention").flash_attention_f32
    # q, k, v, out, B, H, Hkv, Sq, Sk, D, causal, stream
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bind_lse():
    fn = build.load_library("flash_attention").flash_attention_fwd_lse_f32
    # q, k, v, out, lse, B, H, Hkv, Sq, Sk, D, causal, stream
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bind_bwd():
    fn = build.load_library("flash_attention_bwd").flash_attention_bwd_f32
    # q, k, v, out, dout, lse, di, dq, dk, dv, ws, tickets, n_tickets, B,
    # H, Hkv, Sq, Sk, D, causal, stream
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 +
                   [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be [B, H, Sq, D] and k/v [B, Hkv, Sk, D]; "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    b, h, sq, d = q.shape
    bk, hkv, sk, dk = k.shape
    if v.shape != k.shape or bk != b or dk != d:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if sq < 1 or sk < 1:
        raise ValueError("empty query or key axis")
    if causal and sq != sk:
        # the Pallas kernel masks from the top left, its jnp oracle from
        # the bottom right; the two agree only for Sq == Sk
        raise ValueError(f"causal attention needs Sq == Sk (got Sq={sq}, "
                         f"Sk={sk}): the reference kernel and its oracle "
                         f"align the causal mask differently otherwise")
    for t in (q, k, v):
        if t.dtype != torch.float32:
            raise TypeError(f"q/k/v must be float32, got {t.dtype}")
    return b, h, hkv, sq, sk, d


def _check_card(q, tensors, h, hkv, d, b):
    """What the CUDA kernels take, for tensors on the card."""
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}; one is on "
                             f"{t.device}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the CUDA kernel takes contiguous inputs that "
                             "start 16-byte aligned")
    if not kernel_takes(d, h // hkv):
        raise ValueError(f"the kernel takes head_dim a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}] and a GQA group in [1, "
                         f"{MAX_GROUP}]; got head_dim {d}, group {h // hkv}")
    if b > 65535 or hkv > 65535:
        raise ValueError("B and Hkv must be at most 65535 (grid limits)")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_attention(q, k, v, causal: bool = True):
    """Blockwise online-softmax GQA attention.

    q: [B, H, Sq, D] f32; k/v: [B, Hkv, Sk, D] f32 with H a multiple of
    Hkv.  ``causal`` keeps key positions <= the query position and needs
    Sq == Sk.  Returns [B, H, Sq, D] f32.
    """
    b, h, hkv, sq, sk, d = _check(q, k, v, causal)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    _check_card(q, (q, k, v), h, hkv, d, b)
    out = torch.empty_like(q)
    err = _bind()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, h, hkv, sq, sk, d, int(causal), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention_f32 launch failed: "
                           f"cudaError_t {err}")
    LAUNCHES["flash_attention_f32"] += 1
    return out


def flash_attention_lse(q, k, v, causal: bool = True):
    """:func:`flash_attention` that also returns each query row's
    natural-log logsumexp of its scaled, masked scores: (out [B, H, Sq,
    D], lse [B, H, Sq]), both f32.  ``out`` is :func:`flash_attention`'s,
    bit for bit."""
    b, h, hkv, sq, sk, d = _check(q, k, v, causal)
    if q.device.type == "cpu":
        return ref.flash_attention_lse_ref(q, k, v, causal=causal)
    _check_card(q, (q, k, v), h, hkv, d, b)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _bind_lse()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), b, h, hkv, sq, sk, d,
                      int(causal), _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd_lse_f32 launch failed: "
                           f"cudaError_t {err}")
    LAUNCHES["flash_attention_fwd_lse_f32"] += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True):
    """Gradient of :func:`flash_attention` with respect to q, k and v,
    from the forward's ``out`` and ``lse`` (:func:`flash_attention_lse`)
    and the output's gradient ``dout`` [B, H, Sq, D].  Returns (dq, dk,
    dv), f32, shaped as q, k, v; deterministic (no float atomics).  On
    the tensor-core route with G > 1 it allocates the workspace of the
    G heads' dK/dV shares and takes a stream's merge tickets
    (``ref.flash_bwd_plan``)."""
    b, h, hkv, sq, sk, d = _check(q, k, v, causal)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be shaped as q "
                         f"{tuple(q.shape)}")
    if lse.shape != (b, h, sq):
        raise ValueError(f"lse must be [B, H, Sq] = {(b, h, sq)}; got "
                         f"{tuple(lse.shape)}")
    for t in (out, lse, dout):
        if t.dtype != torch.float32:
            raise TypeError(f"out/lse/dout must be float32, got {t.dtype}")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                           causal=causal)
    _check_card(q, (q, k, v, out, lse, dout), h, hkv, d, b)
    if h > 65535:
        raise ValueError("H must be at most 65535 (grid limits)")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    di = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = _stream(q)
    ws = tickets = None
    n_tickets = 0
    if ref.flash_bwd_mma(d, h // hkv):
        plan = ref.flash_bwd_plan(b, h, hkv, sq, sk, d)
        if plan.tickets:
            ws = torch.empty(plan.workspace, dtype=torch.float32,
                             device=q.device)
            tickets = merge_tickets(q.device, stream, plan.tickets)
            n_tickets = tickets.numel()
    err = _bind_bwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                      di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), _ptr(ws), _ptr(tickets), n_tickets, b,
                      h, hkv, sq, sk, d, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_f32 launch failed: "
                           f"cudaError_t {err}")
    LAUNCHES["flash_attention_bwd_f32"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient: the forward launches
    :func:`flash_attention_lse` and saves q, k, v, out and lse; the
    backward launches :func:`flash_attention_bwd`.  Under
    ``torch.utils.checkpoint`` the forward runs twice a step (each run
    counted)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_lse(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_attention_with_grad(q, k, v, causal: bool = True):
    """:func:`flash_attention` under autograd (:class:`FlashAttentionFn`);
    same arguments."""
    return FlashAttentionFn.apply(q, k, v, causal)
