"""Wrappers of the hand-written paged-attention CUDA kernels.

``csrc/paged_attention.cu`` replaces the JAX package's Pallas TPU
kernels ``_paged_kernel`` and ``_paged_q8_kernel``
(``repro/kernels/paged_attention.py:39, :77``) with two forms behind
each wrapper; the function computed and the signature stay the Pallas
kernel's whichever form runs.  Full-precision pages are f32 or bf16
(the bf16 kernels are ``csrc/paged_attention_bf16.cu``'s library, the
same templates at another element type); q is f32 either way:

* the chunk form, when every row of ``page_table`` is the same row, seen
  as ``page_table.stride(0) == 0`` (the view ``row[None].expand(C,
  pps)`` gives; the prefill chunk of ``PagedServer`` passes it): one
  block per (tile of query rows, kv head) shares each K/V tile across
  the tile's rows;
* the decode form, for a contiguous table: split-K over pages (the
  split count chosen here from B, Hkv, pps and the SM count, never from
  ``lengths``), then ``paged_combine_f32``'s kernel merges the split
  partials (what :func:`combine_splits` does), also at one split; one
  launcher call starts both kernels.

The pool form (:func:`paged_attention_pool`, :func:`paged_attention_pool_q8`)
runs either form for N emulated nodes sharing one store, node s owning
the physical pages ``[s * n_local, (s + 1) * n_local)`` (the reference's
per-node ``paged_attention_partial`` and its ``combine_partials`` across
the pool axis), in one launch: each node's blocks list the pages of
their row that the node owns and walk only those (the decode form's
split t of node s the owned pages of rank ``[t * per, (t + 1) * per)``,
``ref.pool_split_owned``; the chunk form's tiles the node's owned keys,
``ref.pool_chunk_tiles``), write their partials at node offset s of one
workspace, and the last block of each group to finish merges the
group's partials into the output (a ticket a group, in a zeroed buffer
``scratch.merge_tickets`` keeps per stream).  At one node whose window is the whole store it
computes the forms' own bits.

Each wrapper checks device, dtype, shape and layout and raises on what
the kernels do not take (a non-contiguous table other than an expanded
row among it), allocates the output and the split workspace with
``torch.empty``, launches on the current CUDA stream and raises if a
launcher returns a CUDA error.  For tensors on the CPU (and only there)
it runs the plain version in ``kernels.ref`` instead.  ``LAUNCHES``
counts kernel launches, one entry per compiled kernel; nothing else adds
to it.

Page ids are trusted: the table's entries below ``ceil(length/page)``
must name pages of ``k_pages`` (the serving path's ``PageTableManager``
guarantees it); checking them would cost a device-to-host sync per call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.scratch import merge_tickets

LAUNCHES = {"paged_decode_f32": 0, "paged_decode_bf16": 0,
            "paged_decode_q8_int8": 0, "paged_decode_q8_fp8": 0,
            "paged_chunk_f32": 0, "paged_chunk_bf16": 0,
            "paged_chunk_q8_int8": 0, "paged_chunk_q8_fp8": 0,
            "paged_pool_decode_f32": 0, "paged_pool_decode_bf16": 0,
            "paged_pool_decode_q8_int8": 0, "paged_pool_decode_q8_fp8": 0,
            "paged_pool_chunk_f32": 0, "paged_pool_chunk_bf16": 0,
            "paged_pool_chunk_q8_int8": 0, "paged_pool_chunk_q8_fp8": 0,
            "paged_combine_f32": 0}

_CODE = {torch.float32: "f32", torch.bfloat16: "bf16",
         torch.int8: "q8_int8", torch.float8_e4m3fn: "q8_fp8"}
#: page dtypes of the full-precision wrappers (read as f32 in the
#: kernels) and of the quantized ones (codes with f32 scales)
FLOAT_PAGES = (torch.float32, torch.bfloat16)
CODE_PAGES = (torch.int8, torch.float8_e4m3fn)

COMBINE = "paged_combine_f32"
#: the shapes the kernels take (:func:`kernel_takes`)
MAX_HEAD_DIM = 256
MAX_PAGE = 1024
MAX_GROUP = 64
#: decode form: blocks per SM the split count aims for, and the fewest
#: pages a split walks
SPLIT_BLOCKS_PER_SM = 4
MIN_SPLIT_PAGES = 2
#: the most partials of a row ``paged_combine_f32`` (and the pool form's
#: merge) takes (its weights fill the shared memory of a block of 4
#: warps), and the most split blocks of a row the decode grid holds
MAX_COMBINE = 232448 // 16
MAX_GRID_Z = 65535
#: rows of a chunk-form block (query positions x the GQA group)
CHUNK_ROWS = 64
#: decode form: query heads a block (a larger group takes several)
BLOCK_HEADS = 32


@functools.lru_cache(maxsize=None)
def _bind(name: str, n_pointers: int, n_ints: int):
    # the bf16 instantiations are a library of their own
    # (csrc/paged_attention_bf16.cu)
    lib = ("paged_attention_bf16" if name.endswith("_bf16")
           else "paged_attention")
    fn = getattr(build.load_library(lib), name)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints +
                   [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def split_plan(b: int, hkv: int, pps: int, n_sm: int):
    """(splits, pages a split walks) of the decode form: enough (b, kv
    head, split) blocks for ``SPLIT_BLOCKS_PER_SM`` a SM, at least
    ``MIN_SPLIT_PAGES`` pages a split (or one split), no split empty of
    table columns."""
    want = -(-SPLIT_BLOCKS_PER_SM * n_sm // (b * hkv))
    splits = max(1, min(want, pps // MIN_SPLIT_PAGES))
    per = -(-pps // splits)
    return -(-pps // per), per


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


def kernel_takes(head_dim: int, page: int, group: int) -> bool:
    """Whether both forms take this shape: a head_dim that is a multiple
    of 8 from 8 to 256 (instantiated at the next multiple of 32, the
    columns past it zero), pages of 1 to ``MAX_PAGE`` tokens (the decode
    form stages a page above 64 tokens as several tiles), a GQA group of
    1 to ``MAX_GROUP`` heads (the decode form gives a group above 32 two
    blocks).  The same rule as ``bad_shape`` in ``csrc/paged_attention.cu``."""
    return (head_dim % 8 == 0 and 8 <= head_dim <= MAX_HEAD_DIM and
            1 <= page <= MAX_PAGE and 1 <= group <= MAX_GROUP)


def _shared_row(page_table) -> bool:
    """Every row of the table is one row: the chunk form's input."""
    return page_table.stride(0) == 0 and page_table.stride(1) == 1


def _check_cuda(tensors, page_table, d, page, group):
    dev = tensors[0].device
    for t in (*tensors, page_table):
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}; one is on "
                             f"{t.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernels take contiguous inputs only")
    if not (page_table.is_contiguous() or _shared_row(page_table)):
        raise ValueError("page_table must be contiguous, or one row "
                         "expanded over the batch (stride (0, 1))")
    if any(t.data_ptr() % 16 for t in tensors[1:3]):
        raise ValueError("the page tensors must start 16-byte aligned "
                         "(the kernels read them in 16-byte vectors)")
    if not kernel_takes(d, page, group):
        raise ValueError(f"head_dim {d}, page {page}, GQA group {group}: "
                         f"the kernels take a head_dim that is a multiple of "
                         f"8 from 8 to {MAX_HEAD_DIM}, pages of at most "
                         f"{MAX_PAGE} tokens and groups of at most "
                         f"{MAX_GROUP} heads")
    if tensors[0].shape[0] < 1 or page_table.shape[1] < 1:
        raise ValueError("empty batch or page table")


def pool_groups(form: str, rows: int, h: int, hkv: int) -> int:
    """Groups of blocks a pool launch merges, one ticket each: the
    decode form's (row, kv head, head part), the chunk form's (tile of
    ``CHUNK_ROWS // G`` positions, kv head); ``rows`` is B or C."""
    group = h // hkv
    if form == "decode":
        return rows * hkv * -(-group // BLOCK_HEADS)
    return -(-rows // (CHUNK_ROWS // group)) * hkv


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _args(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths):
    """The launchers' input pointers (None for absent scales)."""
    return (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), page_table.data_ptr(),
            lengths.data_ptr())


@functools.lru_cache(maxsize=None)
def _decode_plan(dtype, b, h, d, page, hkv, pps, per):
    """The decode form at one shape and ``per`` pages a split: (launcher,
    its name, its int arguments, floats of acc [B, H, S, D], floats of m
    and of l [B, H, S]); the workspace holds acc, m, l in that order."""
    splits = -(-pps // per)
    name = f"paged_decode_{_CODE[dtype]}"
    return (_bind(name, 11, 8), name, (b, h, hkv, d, pps, page, per, splits),
            b * h * splits * d, b * h * splits)


def _decode(q, args, plan, out, stream):
    """Launch the decode form on ``plan`` (:func:`_decode_plan`) into a
    new workspace of its partials; with ``out`` (an address) the same
    launcher call then merges them into it (``paged_combine_f32``'s
    kernel).  Returns the workspace; a caller may drop it once launched,
    as the caching allocator hands its memory only to work queued later
    on the same stream."""
    fn, name, ints, n_acc, n_ml = plan
    ws = torch.empty(n_acc + 2 * n_ml, dtype=torch.float32, device=q.device)
    acc = ws.data_ptr()
    _raise_on(fn(*args, acc, acc + 4 * n_acc, acc + 4 * (n_acc + n_ml), out,
                 *ints, stream), name)
    LAUNCHES[name] += 1
    if out is not None:
        LAUNCHES[COMBINE] += 1
    return ws


def _launch(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, b, h,
            d, page, hkv):
    pps = page_table.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = _args(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths)
    out = torch.empty_like(q)
    if _shared_row(page_table):
        name = f"paged_chunk_{_CODE[k_pages.dtype]}"
        _raise_on(_bind(name, 8, 6)(*args, out.data_ptr(), b, h, hkv, d, pps,
                                    page, stream), name)
        LAUNCHES[name] += 1
        return out
    per = split_plan(b, hkv, pps, _sm_count(q.device))[1]
    _decode(q, args, _decode_plan(k_pages.dtype, b, h, d, page, hkv, pps, per),
            out.data_ptr(), stream)
    return out


def combine_splits(acc, m, l):
    """Merge the decode form's split partials by max-rebase (the
    reference's ``combine_partials``): acc [B, H, S, D], m/l [B, H, S]
    f32 -> [B, H, D] = sum acc_s e^(m_s - m*) / max(sum l_s e^(m_s -
    m*), 1e-30), m* = max m_s.  ``paged_combine_f32`` on the card,
    ``ref.combine_splits_ref`` on the CPU."""
    if acc.dim() != 4 or m.shape != acc.shape[:3] or l.shape != m.shape:
        raise ValueError(f"acc must be [B, H, S, D] and m, l [B, H, S]; got "
                         f"{tuple(acc.shape)}, {tuple(m.shape)}, "
                         f"{tuple(l.shape)}")
    if any(t.dtype != torch.float32 for t in (acc, m, l)):
        raise TypeError("partials must be float32")
    if acc.device.type == "cpu":
        return ref.combine_splits_ref(acc, m, l)
    if any(t.device != acc.device or not t.is_contiguous() for t in (m, l)) \
            or not acc.is_contiguous():
        raise ValueError("partials must be contiguous, on one device")
    b, h, splits, d = acc.shape
    out = torch.empty((b, h, d), dtype=torch.float32, device=acc.device)
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    _raise_on(_bind(COMBINE, 4, 3)(acc.data_ptr(), m.data_ptr(), l.data_ptr(),
                                   out.data_ptr(), b * h, splits, d, stream),
              COMBINE)
    LAUNCHES[COMBINE] += 1
    return out


def split_partials(q, k_pages, v_pages, page_table, lengths, k_scale=None,
                   v_scale=None, *, pages_per_split: int):
    """The decode form's per-split partials at ``pages_per_split`` pages
    a split: (acc [B, H, S, D], m [B, H, S], l [B, H, S]) f32, S =
    ceil(pps / pages_per_split), un-normalised; a split past a row's
    length is (0, -1e30, 0).  The wrappers merge them with
    :func:`combine_splits`; this exposes them for checks against
    ``ref.paged_split_partials_ref`` (which the CPU runs instead).
    ``page_table`` must be contiguous on the card."""
    quantized = k_scale is not None
    b, h, d, _, page, hkv = _check(q, k_pages, v_pages, page_table, lengths,
                                   CODE_PAGES if quantized else FLOAT_PAGES)
    if pages_per_split < 1:
        raise ValueError("pages_per_split must be >= 1")
    if q.device.type == "cpu":
        return ref.paged_split_partials_ref(q, k_pages, v_pages, page_table,
                                            lengths, pages_per_split,
                                            k_scale, v_scale)
    scales = (k_scale, v_scale) if quantized else ()
    _check_cuda((q, k_pages, v_pages, *scales, lengths), page_table, d,
                page, h // hkv)
    if not page_table.is_contiguous():
        raise ValueError("split_partials takes a contiguous page_table")
    args = _args(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths)
    plan = _decode_plan(k_pages.dtype, b, h, d, page, hkv,
                        page_table.shape[1], pages_per_split)
    ws = _decode(q, args, plan, None,
                 torch.cuda.current_stream(q.device).cuda_stream)
    _, _, ints, n_acc, n_ml = plan
    splits = ints[-1]
    return (ws[:n_acc].view(b, h, splits, d),
            ws[n_acc:n_acc + n_ml].view(b, h, splits),
            ws[n_acc + n_ml:].view(b, h, splits))


def paged_attention(q, k_pages, v_pages, page_table, lengths):
    """GQA attention over a paged KV pool.

    q: [B, H, D] f32; k_pages/v_pages: [P, page, Hkv, D] f32 or bf16
    (bf16 elements widened to f32 where read, as the Pallas body widens
    its pages); page_table: [B, pps] int32 physical ids, contiguous or
    one row expanded over B (then the chunk form runs); lengths: [B]
    int32 valid positions (0 = padding row, returns zeros).  Returns [B,
    H, D] f32.
    """
    b, h, d, _, page, hkv = _check(q, k_pages, v_pages, page_table,
                                   lengths, FLOAT_PAGES)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, page_table,
                                       lengths)
    _check_cuda((q, k_pages, v_pages, lengths), page_table, d, page,
                h // hkv)
    return _launch(q, k_pages, v_pages, None, None, page_table, lengths, b,
                   h, d, page, hkv)


def paged_attention_q8(q, k_pages, v_pages, k_scale, v_scale, page_table,
                       lengths):
    """The same attention over int8 or fp8-e4m3 codes.

    k_pages/v_pages: [P, page, Hkv, D] ``torch.int8`` or
    ``torch.float8_e4m3fn``; k_scale/v_scale: [P, page, Hkv] f32
    per-slot scales.  The k scale multiplies the logits and the v scale
    the probabilities; no f32 page is materialised on the card.
    """
    b, h, d, n_phys, page, hkv = _check(q, k_pages, v_pages, page_table,
                                        lengths, CODE_PAGES)
    sshape = (n_phys, page, hkv)
    if tuple(k_scale.shape) != sshape or tuple(v_scale.shape) != sshape:
        raise ValueError(f"scales must be {sshape}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("scales must be float32")
    if q.device.type == "cpu":
        return ref.paged_attention_q8_ref(q, k_pages, v_pages, k_scale,
                                          v_scale, page_table, lengths)
    _check_cuda((q, k_pages, v_pages, k_scale, v_scale, lengths),
                page_table, d, page, h // hkv)
    # fp8 codes: the bytes are handed over as-is and read as __nv_fp8_e4m3
    return _launch(q, k_pages, v_pages, k_scale, v_scale, page_table,
                   lengths, b, h, d, page, hkv)


def _check_pool(k_pages, n_nodes: int, n_local: int):
    if n_nodes < 1 or n_local < 1:
        raise ValueError(f"n_nodes={n_nodes} and n_local={n_local} must be "
                         f">= 1")
    if n_nodes * n_local != k_pages.shape[0]:
        raise ValueError(f"{n_nodes} windows of {n_local} pages do not tile "
                         f"the store's {k_pages.shape[0]} pages")


def _pool_splits(page_table, b, hkv, n_nodes, device, pages_per_split=None):
    """(pages a split walks, splits a node) of the pool decode form: the
    single-device plan (:func:`split_plan`) unless ``pages_per_split``
    is given.  Raises where N * S passes the grid or the combine."""
    pps = page_table.shape[1]
    per = (split_plan(b, hkv, pps, _sm_count(device))[1]
           if pages_per_split is None else int(pages_per_split))
    if per < 1:
        raise ValueError("pages_per_split must be >= 1")
    splits = -(-pps // per)
    if n_nodes * splits > min(MAX_COMBINE, MAX_GRID_Z):
        raise ValueError(f"{n_nodes} nodes x {splits} splits = "
                         f"{n_nodes * splits} partials a row; the combine "
                         f"merges at most {min(MAX_COMBINE, MAX_GRID_Z)}")
    return per, splits


def _pool_launch(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
                 b, h, d, page, hkv, n_nodes, n_local, merge=True,
                 pages_per_split=None):
    """Launch the pool form; returns (out or None, acc, m, l), the
    partials node-major: acc [B, H, N * S, D], m/l [B, H, N * S] (S = 1
    for the chunk form).  With ``merge`` the same launch merges them
    into ``out``."""
    pps = page_table.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = _args(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths)
    shared = _shared_row(page_table)
    out = torch.empty_like(q) if merge else None
    code = _CODE[k_pages.dtype]
    if shared:
        if n_nodes > MAX_COMBINE:
            raise ValueError(f"{n_nodes} nodes: the merge takes at most "
                             f"{MAX_COMBINE} partials a row")
        name, splits, form = f"paged_pool_chunk_{code}", 1, "chunk"
        ints = (b, h, hkv, d, pps, page, n_nodes, n_local)
    else:
        per, splits = _pool_splits(page_table, b, hkv, n_nodes, q.device,
                                   pages_per_split)
        name, form = f"paged_pool_decode_{code}", "decode"
        ints = (b, h, hkv, d, pps, page, per, splits, n_nodes, n_local)
    n_tickets = pool_groups(form, b, h, hkv)
    tickets = merge_tickets(q.device, stream, n_tickets)
    n_ml = b * h * n_nodes * splits
    ws = torch.empty(n_ml * (d + 2), dtype=torch.float32, device=q.device)
    acc = ws.data_ptr()
    _raise_on(_bind(name, 12, len(ints) + 1)(
        *args, acc, acc + 4 * n_ml * d, acc + 4 * n_ml * (d + 1),
        None if out is None else out.data_ptr(), tickets.data_ptr(), *ints,
        tickets.numel(), stream), name)
    LAUNCHES[name] += 1
    return (out, ws[:n_ml * d].view(b, h, n_nodes * splits, d),
            ws[n_ml * d:n_ml * (d + 1)].view(b, h, n_nodes * splits),
            ws[n_ml * (d + 1):].view(b, h, n_nodes * splits))


def _pool(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
          n_nodes, n_local):
    quantized = k_scale is not None
    b, h, d, n_phys, page, hkv = _check(
        q, k_pages, v_pages, page_table, lengths,
        CODE_PAGES if quantized else FLOAT_PAGES)
    _check_pool(k_pages, n_nodes, n_local)
    if quantized:
        sshape = (n_phys, page, hkv)
        if tuple(k_scale.shape) != sshape or tuple(v_scale.shape) != sshape:
            raise ValueError(f"scales must be {sshape}")
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError("scales must be float32")
    if q.device.type == "cpu":
        return ref.paged_pool_attention_ref(q, k_pages, v_pages, page_table,
                                            lengths, n_nodes, n_local,
                                            k_scale, v_scale)
    scales = (k_scale, v_scale) if quantized else ()
    _check_cuda((q, k_pages, v_pages, *scales, lengths), page_table, d,
                page, h // hkv)
    return _pool_launch(q, k_pages, v_pages, k_scale, v_scale, page_table,
                        lengths, b, h, d, page, hkv, n_nodes, n_local)[0]


def paged_attention_pool(q, k_pages, v_pages, page_table, lengths, *,
                         n_nodes: int, n_local: int):
    """:func:`paged_attention` over a pool of ``n_nodes`` nodes of
    ``n_local`` pages (``n_nodes * n_local == P``): each node attends
    over the table columns whose physical page lies in its window, and
    the nodes' online-softmax partials are merged by max-rebase.  The
    same function as :func:`paged_attention` whatever the windows; at
    one node, its bits."""
    return _pool(q, k_pages, v_pages, None, None, page_table, lengths,
                 n_nodes, n_local)


def paged_attention_pool_q8(q, k_pages, v_pages, k_scale, v_scale,
                            page_table, lengths, *, n_nodes: int,
                            n_local: int):
    """:func:`paged_attention_pool` over int8 / fp8-e4m3 codes with
    per-slot f32 scales (as :func:`paged_attention_q8`)."""
    return _pool(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
                 n_nodes, n_local)


def pool_partials(q, k_pages, v_pages, page_table, lengths, k_scale=None,
                  v_scale=None, *, n_nodes: int, n_local: int,
                  pages_per_split=None):
    """The pool form's partials, unmerged (the kernel launched without
    its merge), node-major: (acc [B, H, N, S, D], m [B, H, N, S], l [B,
    H, N, S]) f32, un-normalised.  The decode form's split t of node s
    covers the pages of rank ``[t * per, (t + 1) * per)`` among the
    row's pages below its length that lie in node s's window
    (``ref.pool_split_owned``), ``per = pages_per_split`` (default:
    :func:`split_plan`'s on the card, one split on the CPU), S = ceil(pps
    / per); the chunk form's one partial a node (S = 1, an expanded
    table).  A (row, node, split) that owns no position below the row's
    length is (0, -1e30, 0).  Merged per node they are
    ``ref.paged_pool_partials_ref``; :func:`combine_splits` of them
    (reshaped to [B, H, N * S, D]) is the pool wrappers' output bit for
    bit on the card.  The CPU runs ``ref.paged_pool_split_partials_ref``."""
    quantized = k_scale is not None
    b, h, d, _, page, hkv = _check(q, k_pages, v_pages, page_table, lengths,
                                   CODE_PAGES if quantized else FLOAT_PAGES)
    _check_pool(k_pages, n_nodes, n_local)
    if q.device.type == "cpu":
        per = (page_table.shape[1] if pages_per_split is None or
               _shared_row(page_table) else int(pages_per_split))
        acc, m, l = ref.paged_pool_split_partials_ref(
            q, k_pages, v_pages, page_table, lengths, n_nodes, n_local, per,
            k_scale, v_scale)
    else:
        scales = (k_scale, v_scale) if quantized else ()
        _check_cuda((q, k_pages, v_pages, *scales, lengths), page_table, d,
                    page, h // hkv)
        _, acc, m, l = _pool_launch(q, k_pages, v_pages, k_scale, v_scale,
                                    page_table, lengths, b, h, d, page, hkv,
                                    n_nodes, n_local, merge=False,
                                    pages_per_split=pages_per_split)
    s = acc.shape[2] // n_nodes
    return (acc.view(b, h, n_nodes, s, d), m.view(b, h, n_nodes, s),
            l.view(b, h, n_nodes, s))
