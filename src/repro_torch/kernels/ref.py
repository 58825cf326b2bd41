"""Plain PyTorch versions of the port's kernels.

The paged-attention versions follow the conventions of the JAX package's Pallas kernels
(``repro/kernels/paged_attention.py``), not those of its jnp oracles:

  * a row with ``length == 0`` returns zeros (``acc / max(l, 1e-30)``
    with ``l == 0``), where the jnp oracle returns a uniform average;
  * pages at or past ``length`` are never read: their table entries are
    replaced by page 0 before the gather, and their positions carry no
    weight;
  * for the quantized pages, the k scale multiplies the logits and the
    v scale multiplies the probabilities.

The in-storage scan, top-k and embedding versions (below) write out
the order of every f32 add that the JAX package's contract fixes.

The CPU path of every wrapper in ``kernels.paged_attention``,
``kernels.isp_scan`` and ``kernels.embed_agg`` runs these, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

NEG_INF = -1e30


def _gather_pages(pages, safe_table):
    """pages [P, page, ...] gathered by [B, pps] ids -> [B, pps, page,
    ...] in f32 (fp8 codes are gathered as bytes: CPU indexing kernels
    do not all take float8)."""
    if pages.dtype == torch.float8_e4m3fn:
        return pages.view(torch.uint8)[safe_table].view(pages.dtype).float()
    return pages[safe_table].float()


def paged_partials_ref(q, k_pages, v_pages, page_table, lengths, k_scale,
                       v_scale, col_owned=None):
    """Un-normalised online-softmax state over the table columns
    ``col_owned`` [B, pps] selects (all when None): acc [B, H, D], m
    [B, H], l [B, H] f32.  A row with no owned position below its length
    gives (0, -1e30, 0)."""
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    pps = page_table.shape[1]
    g = h // hkv
    sm_scale = 1.0 / math.sqrt(d)
    lengths = lengths.long()
    col = torch.arange(pps, device=q.device)
    page_live = col[None, :] * page < lengths[:, None]             # [B, pps]
    if col_owned is not None:
        page_live = page_live & col_owned
    safe = torch.where(page_live, page_table.long(),
                       torch.zeros_like(page_table, dtype=torch.long))
    k = _gather_pages(k_pages, safe)                  # [B, pps, page, Hkv, D]
    v = _gather_pages(v_pages, safe)
    qg = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bkgd,bptkd->bkgpt", qg, k)
    if k_scale is not None:
        ks = k_scale[safe].permute(0, 3, 1, 2)                # [B, Hkv, pps, page]
        s = s * ks[:, :, None]
    s = s * sm_scale
    pos = col[:, None] * page + torch.arange(page, device=q.device)[None, :]
    mask = (pos[None] < lengths[:, None, None]) & page_live[:, :, None]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    sf = s.reshape(b, hkv, g, pps * page)
    mf = mask.reshape(b, 1, 1, pps * page)
    m = sf.amax(dim=-1, keepdim=True)
    p = torch.where(mf, torch.exp(sf - m), torch.zeros_like(sf))
    l = p.sum(dim=-1)                                         # [B, Hkv, G]
    if v_scale is not None:
        vs = v_scale[safe].permute(0, 3, 1, 2).reshape(b, hkv, 1, pps * page)
        p = p * vs
    acc = torch.einsum("bkgt,btkd->bkgd", p, v.reshape(b, pps * page, hkv, d))
    return acc.reshape(b, h, d), m.reshape(b, h), l.reshape(b, h)


def _paged(q, k_pages, v_pages, page_table, lengths, k_scale, v_scale):
    acc, _, l = paged_partials_ref(q, k_pages, v_pages, page_table,
                                   lengths, k_scale, v_scale)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths):
    """q: [B, H, D]; k_pages/v_pages: [P, page, Hkv, D]; page_table:
    [B, pps] int32 physical ids; lengths: [B] int32.  Returns [B, H, D]."""
    return _paged(q, k_pages, v_pages, page_table, lengths, None, None)


def paged_attention_q8_ref(q, k_pages, v_pages, k_scale, v_scale,
                           page_table, lengths):
    """The same over int8 or fp8-e4m3 codes with per-slot f32 scales
    ``k_scale``/``v_scale`` [P, page, Hkv]."""
    return _paged(q, k_pages, v_pages, page_table, lengths, k_scale, v_scale)


def paged_split_partials_ref(q, k_pages, v_pages, page_table, lengths,
                             pages_per_split: int, k_scale=None,
                             v_scale=None):
    """Plain emulation of the decode form's split arithmetic: split s
    owns table columns [s * pages_per_split, (s + 1) * pages_per_split)
    and gives its un-normalised (acc [B, H, S, D], m [B, H, S], l [B, H,
    S]); a split past a row's length gives (0, -1e30, 0).  For tests and
    ``chip_smoke.py``; :func:`combine_splits_ref` merges them."""
    pps = page_table.shape[1]
    col = torch.arange(pps, device=q.device)
    parts = []
    for c0 in range(0, pps, pages_per_split):
        owned = ((col >= c0) & (col < c0 + pages_per_split))[None].expand(
            q.shape[0], pps)
        parts.append(paged_partials_ref(q, k_pages, v_pages, page_table,
                                        lengths, k_scale, v_scale, owned))
    acc, m, l = (torch.stack(x, dim=2) for x in zip(*parts))
    return acc, m, l


def combine_splits_ref(acc, m, l):
    """Max-rebase merge of split partials (the reference's
    ``combine_partials``): m* = max m_s, l = sum l_s e^(m_s - m*), out =
    sum acc_s e^(m_s - m*) / max(l, 1e-30).  acc [B, H, S, D], m/l
    [B, H, S] -> [B, H, D]."""
    m_glob = m.amax(dim=-1, keepdim=True)
    scale = torch.exp(m - m_glob)
    l_glob = (l * scale).sum(dim=-1)
    acc_glob = (acc * scale[..., None]).sum(dim=2)
    return acc_glob / torch.clamp(l_glob, min=1e-30)[..., None]


def window_owned(page_table, node: int, n_local: int):
    """[B, pps] bool: the table columns whose physical page lies in node
    ``node``'s window ``[node * n_local, (node + 1) * n_local)`` (the
    reference's ``col_owned`` of ``local_table = table - base``)."""
    base = node * n_local
    return (page_table >= base) & (page_table < base + n_local)


def paged_pool_partials_ref(q, k_pages, v_pages, page_table, lengths,
                            n_nodes: int, n_local: int, k_scale=None,
                            v_scale=None):
    """Each node's online-softmax partials over its window: the port of
    the reference's ``paged_attention_partial`` (``repro/runtime/
    serve.py:78``) run per node with ``col_owned = window_owned``.
    Returns (acc [N, B, H, D], m [N, B, H], l [N, B, H]) f32; a node that
    owns nothing of a row gives it (0, -1e30, 0)."""
    parts = [paged_partials_ref(q, k_pages, v_pages, page_table, lengths,
                                k_scale, v_scale,
                                window_owned(page_table, s, n_local))
             for s in range(n_nodes)]
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    return acc, m, l


def pool_owned_pages(table_row, length: int, page: int, node: int,
                     n_local: int):
    """The pool form's list of one table row for one node: the logical
    pages (columns below ceil(length / page), at most the row's width)
    whose physical page lies in the node's window, ascending; what a
    pool block lists before it walks (``owned_list`` in
    ``csrc/paged_attention.cu``).  A long int tensor."""
    row = torch.as_tensor(table_row).long()
    n_cols = min(-(-int(length) // page), row.numel())
    base = node * n_local
    own = (row[:n_cols] >= base) & (row[:n_cols] < base + n_local)
    return torch.nonzero(own).flatten()


def pool_split_owned(page_table, lengths, page: int, node: int,
                     n_local: int, per: int, split: int):
    """[B, pps] bool: the table columns the pool decode form's split
    ``split`` of node ``node`` walks, the pages of rank ``[split * per,
    (split + 1) * per)`` of each row's :func:`pool_owned_pages`.  At one
    node whose window is the store, the columns ``[split * per, (split
    + 1) * per)`` below the length: the single decode form's split."""
    pps = page_table.shape[1]
    n_pages = torch.clamp(-(-lengths.long() // page), max=pps)
    col = torch.arange(pps, device=page_table.device)
    win = (window_owned(page_table, node, n_local) &
           (col[None, :] < n_pages[:, None]))
    rank = torch.cumsum(win.long(), dim=1) - 1
    return win & (rank >= split * per) & (rank < (split + 1) * per)


def chunk_tile_keys(head_dim: int) -> int:
    """Keys of a chunk-form tile (``Chunk<D>::KT``): 64, or 32 where the
    head dim rounded up to a multiple of 32 passes 128."""
    return 64 if -(-head_dim // 32) * 32 <= 128 else 32


def pool_chunk_tiles(table_row, kmax: int, page: int, node: int,
                     n_local: int, kt: int):
    """The pool chunk form's tiles for one node block whose longest row
    is ``kmax``: its owned keys below ``kmax`` in ascending order (key i
    on page ``list[i // page]``, slot ``i % page``, of
    :func:`pool_owned_pages`), ``kt`` a tile; each tile the logical
    positions of its keys, which the length mask reads.  At one node
    whose window is the store, ``[0, kt), [kt, 2 kt), ...`` below kmax:
    the single chunk form's tiles."""
    pages = pool_owned_pages(table_row, kmax, page, node, n_local)
    pos = (pages[:, None] * page + torch.arange(page)[None, :]).flatten()
    pos = pos[pos < kmax]
    return [pos[i:i + kt] for i in range(0, pos.numel(), kt)]


def paged_pool_split_partials_ref(q, k_pages, v_pages, page_table, lengths,
                                  n_nodes: int, n_local: int,
                                  pages_per_split: int, k_scale=None,
                                  v_scale=None):
    """Plain emulation of the pool decode form's workspace: node s's
    split t covers the owned pages of rank [t * pages_per_split, (t + 1)
    * pages_per_split) of each row (:func:`pool_split_owned`), at
    partial s * S + t, S = ceil(pps / pages_per_split).  Returns (acc [B,
    H, N * S, D], m, l [B, H, N * S])."""
    pps = page_table.shape[1]
    page = k_pages.shape[1]
    parts = []
    for s in range(n_nodes):
        for t in range(-(-pps // pages_per_split)):
            parts.append(paged_partials_ref(
                q, k_pages, v_pages, page_table, lengths, k_scale, v_scale,
                pool_split_owned(page_table, lengths, page, s, n_local,
                                 pages_per_split, t)))
    acc, m, l = (torch.stack(x, dim=2) for x in zip(*parts))
    return acc, m, l


def merge_split_partials(acc, m, l):
    """Max-rebase of split partials into one partial a node, without the
    normalisation: acc [..., S, D], m/l [..., S] -> (acc [..., D], m
    [...], l [...]).  A node whose splits are all empty stays (0, -1e30,
    0)."""
    m_n = m.amax(dim=-1)
    scale = torch.exp(m - m_n[..., None])
    return ((acc * scale[..., None]).sum(dim=-2), m_n,
            (l * scale).sum(dim=-1))


def paged_pool_attention_ref(q, k_pages, v_pages, page_table, lengths,
                             n_nodes: int, n_local: int, k_scale=None,
                             v_scale=None):
    """The pool form's function: :func:`paged_pool_partials_ref`
    merged across the node axis by :func:`combine_splits_ref` (the
    reference's ``combine_partials``).  At one node whose window is the
    whole store, :func:`paged_attention_ref`'s bits."""
    acc, m, l = paged_pool_partials_ref(q, k_pages, v_pages, page_table,
                                        lengths, n_nodes, n_local, k_scale,
                                        v_scale)
    out = combine_splits_ref(acc.permute(1, 2, 0, 3), m.permute(1, 2, 0),
                             l.permute(1, 2, 0))
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# in-storage scan / filter / reduce and top-k (``repro/kernels/isp_scan.py``)
#
# These are specifications, not speed targets: every f32 sum whose order
# is part of the contract is written out as an explicit sequence of
# elementwise adds (no ``torch.sum``/``cumsum``, whose order is not fixed;
# on the CPU ``cumsum`` even accumulates f32 in double).  The CUDA kernels
# (``csrc/isp_scan.cu``) perform the same adds in the same order, so the
# two are bit-identical.
# ---------------------------------------------------------------------------

POS_INF = 1e30
#: filter predicates over the filter column vs the threshold
FILTER_OPS = ("all", "ge", "lt", "eq", "ne")
#: rows of the aggregate / top-k output block
REDUCE_ROWS = 8
#: scoring metrics of the top-k scan
TOPK_METRICS = ("dot", "cosine")
#: id of an empty top-k slot (exact in f32, above every real row id)
BIG_ID = float(2 ** 30)
#: widest supported k
MAX_TOPK = 128

#: the CUDA top-k walks a page as units of at most this many rows
TOPK_UNIT_ROWS = 256
#: pages of at most this many rows go several whole pages a unit (direct
#: path)
TOPK_GROUP_MAX = 128


def topk_tma_path(page_rows: int, n_cols: int, elem_size: int,
                  quantized: bool, aligned: bool = True) -> bool:
    """Whether the CUDA top-k streams this pool through its TMA ring:
    rows of a multiple of 16 bytes, the pool and query 16-byte aligned,
    and code pages of a multiple of 4 rows (a unit's scales one bulk
    copy); else its direct path (``csrc/isp_scan.cu``, ``launch_topk``)."""
    return (n_cols * elem_size % 16 == 0 and aligned and
            not (quantized and page_rows % 4))


def topk_unit_pages(page_rows: int, tma: bool) -> int:
    """Whole pages a unit of the CUDA top-k: on the direct path pages of
    at most ``TOPK_GROUP_MAX`` rows go as many a unit as fit in
    ``TOPK_UNIT_ROWS`` rows; else 1 (a page is one or more units)."""
    if not tma and page_rows <= TOPK_GROUP_MAX:
        return TOPK_UNIT_ROWS // page_rows
    return 1


def topk_units(n_valid: int, page_rows: int, tma: bool) -> int:
    """Units of the valid pages the CUDA top-k's blocks share out."""
    group = topk_unit_pages(page_rows, tma)
    if group > 1:
        return -(-n_valid // group)
    return n_valid * -(-page_rows // min(page_rows, TOPK_UNIT_ROWS))


def topk_pad(k: int) -> int:
    """Width of the top-k block: pow2-bucketed with a floor of 128, the
    wire format ``OffloadPlanner.estimate`` prices."""
    return max(128, 1 << max(int(k) - 1, 0).bit_length())


def n_valid_pages(n_rows: int, page_rows: int, pps: int) -> int:
    """Pages of a table that hold the extent's rows (at least one, at
    most the table's length): the kernels read no page past these."""
    return min(max(-(-int(n_rows) // page_rows), 1), pps)


def _predicate(key, threshold, op: str):
    if op == "all":
        return torch.ones_like(key, dtype=torch.bool)
    if op == "ge":
        return key >= threshold
    if op == "lt":
        return key < threshold
    if op == "eq":
        return key == threshold
    if op == "ne":
        return key != threshold
    raise ValueError(f"filter_op must be one of {FILTER_OPS}, got {op!r}")


def pool_rows(pages, scales, ids):
    """Pages ``ids`` of a pool as f32 [n, page_rows, n_cols]; a quantized
    pool dequantises each row as ``codes.float() * scale``."""
    x = _gather_pages(pages, ids)
    if scales is not None:
        x = x * scales.reshape(pages.shape[0], pages.shape[1])[ids][..., None]
    return x


def _page_partials(x, n_rows: int, threshold: float, filter_col: int,
                   filter_op: str):
    """Per-page partials of logical pages x [n, page_rows, C]: the
    passing rows' count and per-column sum in row order 0..page_rows-1
    from 0 (``acc = acc + where(m, v, 0)``), as part [n, 1 + C] f32 numpy
    (count, then sums); and each page's per-column min / max [n, C]
    (from POS_INF / NEG_INF)."""
    n, page_rows, n_cols = x.shape
    dev = x.device
    pos = torch.arange(n * page_rows, device=dev).reshape(n, page_rows)
    thr = torch.tensor(np.float32(threshold), device=dev)
    mask = (pos < n_rows) & _predicate(x[:, :, filter_col], thr, filter_op)
    zero = torch.zeros((), device=dev)
    cnt = torch.zeros((n,), device=dev)
    s = torch.zeros((n, n_cols), device=dev)
    for r in range(page_rows):
        cnt = cnt + mask[:, r].float()
        s = s + torch.where(mask[:, r, None], x[:, r], zero)
    mn = torch.where(mask[..., None], x, POS_INF).amin(dim=1)
    mx = torch.where(mask[..., None], x, NEG_INF).amax(dim=1)
    part = torch.cat([cnt[:, None], s], dim=1).cpu().numpy()
    return part, mn, mx


def fold_page_partials(part, acc=None):
    """The cross-page fold: rows of part [n, V] f32 added in page order
    in f32, each value its own chain (numpy's accumulate is a sequential
    f32 loop), after ``acc`` [V] where given.  Returns [V] f32."""
    part = np.asarray(part, np.float32)
    if acc is not None:
        part = np.concatenate([np.asarray(acc, np.float32)[None], part])
    return np.add.accumulate(part, axis=0)[-1]


def _reduce_block(tot, mn, mx, n_cols: int, dev):
    """The [REDUCE_ROWS, n_cols] block: count (tot[0]) broadcast, sums
    (tot[1:]), min, max; rows 4-7 zero."""
    out = torch.zeros((REDUCE_ROWS, n_cols), device=dev)
    out[0] = float(tot[0])
    out[1] = torch.from_numpy(np.ascontiguousarray(tot[1:])).to(dev)
    out[2] = mn
    out[3] = mx
    return out


def _fold_pages(x, n_rows: int, threshold: float, filter_col: int,
                filter_op: str):
    """The page-sequential fold over logical pages x [n, page_rows, C]:

      * in each page, count and sum the passing rows in row order
        0..page_rows-1, starting from 0 (``acc = acc + where(m, v, 0)``);
      * fold the per-page ``[count, sums]`` across pages in page order,
        in f32 (:func:`fold_page_partials`): the count is in that chain
        too, so above 2^24 rows it rounds as the f32 fold does;
      * min/max (order-free) start from POS_INF/NEG_INF.

    Returns [REDUCE_ROWS, C] f32 on x's device: count broadcast on row
    0, then sum, min, max; rows 4-7 zero."""
    part, mn, mx = _page_partials(x, n_rows, threshold, filter_col,
                                  filter_op)
    return _reduce_block(fold_page_partials(part), mn.amin(dim=0),
                         mx.amax(dim=0), x.shape[2], x.device)


def scan_filter_reduce_ref(pages, page_table, n_rows: int, threshold=0.0, *,
                           scales=None, filter_col: int = 0,
                           filter_op: str = "all"):
    """Filtered aggregate over an extent's pages of a pool.

    pages: [n_phys, page_rows, n_cols] f32, or int8/fp8 codes with
    ``scales`` [n_phys, page_rows] f32; page_table: [pps] int32 (only
    the first ``n_valid_pages`` entries are read, so pow2 padding is
    free); n_rows/threshold: host scalars (threshold rounded to f32).
    Returns [REDUCE_ROWS, n_cols] f32, folded as :func:`_fold_pages`."""
    page_rows = pages.shape[1]
    nv = n_valid_pages(n_rows, page_rows, page_table.shape[0])
    x = pool_rows(pages, scales, page_table[:nv].long())
    return _fold_pages(x, n_rows, threshold, filter_col, filter_op)


def scan_filter_reduce_host(data, threshold=0.0, *, page_rows: int,
                            filter_col: int = 0, filter_op: str = "all"):
    """The same fold over a fetched extent data [n_rows, n_cols] (the
    host-reads-everything path): bit-identical to the pool fold."""
    n_rows, n_cols = data.shape
    n = -(-max(n_rows, 1) // page_rows)
    x = torch.zeros((n * page_rows, n_cols), device=data.device)
    x[:n_rows] = data
    return _fold_pages(x.reshape(n, page_rows, n_cols), n_rows, threshold,
                       filter_col, filter_op)


# The CUDA scan's work split (``csrc/isp_scan.cu``, ``scan_kernel``):
# one launch of n_fold + n_prod blocks.  Producer block b takes chunks b,
# b + n_prod, ... of ``chunk_pages`` valid pages (interleaved, so the
# folded prefix grows evenly), streams them (TMA: whole pages,
# ``unit_pages`` a ring stage, bulk-copied with their row scales; else
# read from device memory) and writes each page's fold values (its
# count, then each column's sum) to a workspace [n_cols + 1, pad_pages],
# then a ready flag a chunk.  Fold block f adds values [(q * n_fold + f)
# * vw, ... + vw) of pass q (one lane a value) in page order, slot by
# slot of ``slot_pages`` pages, as the chunks become ready.

#: consumer threads of a scan block (a TMA block adds a producer warp)
SCAN_THREADS = 256
#: shared memory of a block's stage ring (two blocks an SM)
SCAN_RING_BYTES = 104 * 1024
#: a TMA ring stage holds as many whole pages as fit this
SCAN_STAGE_BYTES = 17 * 1024
SCAN_MAX_STAGES = 8
#: pages a stage (a lane of the producer warp each)
SCAN_UNIT_PAGES = 32
#: a chunk holds at least this many rows (whole pages), or a page for
#: each of a block's (page, column) threads, ...
SCAN_CHUNK_ROWS = 2048
#: ... and no more than this many bytes of a fold block's values
SCAN_CHUNK_FOLD_BYTES = 32 * 1024
#: a fold slot holds whole chunks, up to this many bytes of values
SCAN_SLOT_BYTES = 16 * 1024
SCAN_MAX_SLOTS = 8
#: values a fold block adds (a lane each): at least, at most
SCAN_FOLD_VALUES = 8
SCAN_MAX_FOLD_VALUES = 32
SCAN_MAX_FOLD_BLOCKS = 32
#: dynamic shared memory a block may have on the card
SCAN_MAX_SMEM = 227 * 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _scan_page_layout(page_rows: int, n_cols: int, elem_size: int,
                      quantized: bool):
    """(page bytes, page stride in a stage, scale bytes) of a TMA stage:
    a page's stride is padded so the pages of a warp's threads fall on
    other banks."""
    page_bytes = page_rows * n_cols * elem_size
    pad = _round_up(min(n_cols * elem_size, 64), 16)
    return (page_bytes, _round_up(page_bytes, 128) + pad,
            page_rows * 4 if quantized else 0)


def scan_tma_path(page_rows: int, n_cols: int, elem_size: int,
                  quantized: bool, aligned: bool = True) -> bool:
    """Whether the CUDA scan streams this pool's pages through its TMA
    ring: pages of a multiple of 16 bytes from a 16-byte-aligned pool
    (and scales), code pages of a multiple of 4 rows (their scales one
    bulk copy), a page and its scales within half the ring; else its
    direct path (threads read their rows from device memory)."""
    page_bytes, stride, sc = _scan_page_layout(page_rows, n_cols, elem_size,
                                               quantized)
    return (page_bytes % 16 == 0 and aligned and
            not (quantized and page_rows % 4) and
            stride + sc + 4 * -(-page_rows // 32) <= SCAN_RING_BYTES // 2)


class ScanPlan(NamedTuple):
    tma: bool
    chunk_pages: int
    unit_pages: int     # pages a ring stage (TMA), else chunk_pages
    n_stages: int       # TMA ring stages (0 on the direct path)
    page_stride: int    # bytes between a stage's pages (TMA)
    stage_bytes: int
    mask_words: int     # a stage's row-filter bits, in 32-bit words (TMA)
    vw: int             # fold values a fold block adds in a pass
    n_fold: int         # fold blocks
    passes: int
    slot_pages: int
    slot_stride: int    # floats between a slot's value rows
    n_slots: int
    n_chunks: int
    n_prod: int
    pad_pages: int      # a fold value row's length (n_valid rounded to 4)
    smem: int           # dynamic shared memory a block


def scan_plan(n_valid: int, page_rows: int, n_cols: int, elem_size: int,
              quantized: bool, n_blocks: int,
              aligned: bool = True) -> ScanPlan:
    """The CUDA scan's split of n_valid pages over at most ``n_blocks``
    blocks (the wrapper passes it to ``csrc/isp_scan.cu``, the emulation
    follows it).  Raises ValueError where a block's shared memory would
    not fit (more than about 16,000 columns)."""
    tma = scan_tma_path(page_rows, n_cols, elem_size, quantized, aligned)
    n_vals = n_cols + 1
    vw = min(max(_round_up(-(-n_vals // SCAN_MAX_FOLD_BLOCKS), 4),
                 SCAN_FOLD_VALUES), SCAN_MAX_FOLD_VALUES)
    n_fold = min(-(-n_vals // vw), SCAN_MAX_FOLD_BLOCKS)
    passes = -(-n_vals // (vw * n_fold))
    chunk = -(-SCAN_CHUNK_ROWS // page_rows)
    if not tma:     # a page for each (page, column) thread
        chunk = max(chunk, SCAN_THREADS // n_cols)
    chunk = max(1, min(chunk, SCAN_CHUNK_FOLD_BYTES // (vw * 4)))
    unit, n_stages, stride, stage_bytes, mask_words = chunk, 0, 0, 0, 0
    # fold rows go in 16-byte pieces: chunks (and slots) of 4k pages
    step = 4
    if tma:
        _, stride, sc = _scan_page_layout(page_rows, n_cols, elem_size,
                                          quantized)
        unit = max(1, min(SCAN_STAGE_BYTES // (stride + sc), chunk,
                          SCAN_UNIT_PAGES))
        step = unit * 4 // math.gcd(unit, 4)
        stage_bytes = unit * (stride + sc)
        n_stages = max(2, min(SCAN_RING_BYTES // stage_bytes,
                              SCAN_MAX_STAGES))
        mask_words = n_stages * unit * -(-page_rows // 32)
    chunk = _round_up(chunk, step)
    if not tma:
        unit = chunk
    n_chunks = -(-n_valid // chunk)
    slot_pages = chunk * max(1, SCAN_SLOT_BYTES // (chunk * vw * 4))
    slot_stride = slot_pages + 4
    slot_bytes = vw * slot_stride * 4
    n_slots = max(2, min(SCAN_RING_BYTES // slot_bytes, SCAN_MAX_SLOTS))
    ring = max(n_stages * stage_bytes + 4 * mask_words, n_slots * slot_bytes)
    smem = 128 + ring + 8 * max(SCAN_THREADS, n_cols) + 16
    if smem > SCAN_MAX_SMEM:
        raise ValueError(f"the scan kernel takes pools of up to about "
                         f"16,000 columns; {n_cols} need {smem} bytes of "
                         "shared memory a block")
    return ScanPlan(tma, chunk, unit, n_stages, stride, stage_bytes,
                    mask_words, vw, n_fold, passes, slot_pages, slot_stride,
                    n_slots, n_chunks,
                    max(1, min(n_blocks - n_fold, n_chunks)),
                    _round_up(n_valid, 4), smem)


def scan_fold_windows(plan: ScanPlan, n_vals: int):
    """The fold values each (pass, fold block) adds, in the kernel's
    order: a list of ranges of value indices (count 0, then column c's
    sum at 1 + c)."""
    windows = []
    for q in range(plan.passes):
        for f in range(plan.n_fold):
            g0 = (q * plan.n_fold + f) * plan.vw
            if g0 < n_vals:
                windows.append(range(g0, min(g0 + plan.vw, n_vals)))
    return windows


def scan_follow_emulated(part, plan: ScanPlan, trace=None):
    """The fold blocks' fold of part [n_valid, 1 + C] (count, sums) as
    the kernel does it: each window of :func:`scan_fold_windows` adds its
    values from 0, slot by slot (slot k: pages [k * slot_pages, (k + 1) *
    slot_pages)), each page in page order.  Returns [1 + C] f32;
    ``trace["folded"]`` gets each window's page order."""
    part = np.asarray(part, np.float32)
    n, n_vals = part.shape
    tot = np.zeros(n_vals, np.float32)
    for w in scan_fold_windows(plan, n_vals):
        cols = slice(w.start, w.stop)
        acc = np.zeros(len(w), np.float32)
        order = []
        for p0 in range(0, n, plan.slot_pages):
            p1 = min(p0 + plan.slot_pages, n)
            acc = fold_page_partials(part[p0:p1, cols], acc)
            order += range(p0, p1)
        tot[cols] = acc
        if trace is not None:
            trace.setdefault("folded", []).append(order)
    return tot


def scan_blocks_emulated(pages, page_table, n_rows: int, threshold=0.0, *,
                         scales=None, filter_col: int = 0,
                         filter_op: str = "all", n_blocks: int,
                         aligned: bool = True, trace=None):
    """A plain emulation of the CUDA scan's work split (the comment above
    ``SCAN_THREADS``), equal to :func:`scan_filter_reduce_ref` bit for
    bit: :func:`scan_plan` at ``n_blocks`` blocks, the producers' chunks
    and ring units writing each page's fold values once, each producer
    folding min/max over its pages, and :func:`scan_follow_emulated`.
    ``trace``, a dict, receives the plan, each page's producer block
    (``producer``), the units (block, chunk, first page, pages) and each
    fold window's page order (``folded``)."""
    n_phys, page_rows, n_cols = pages.shape
    nv = n_valid_pages(n_rows, page_rows, page_table.shape[0])
    plan = scan_plan(nv, page_rows, n_cols, pages.element_size(),
                     scales is not None, n_blocks, aligned)
    x = pool_rows(pages, scales, page_table[:nv].long())
    part, mn, mx = _page_partials(x, n_rows, threshold, filter_col,
                                  filter_op)
    ws = np.full_like(part, np.nan)
    producer = [None] * nv
    units = []
    blk_mn = torch.full((plan.n_prod, n_cols), POS_INF, device=x.device)
    blk_mx = torch.full((plan.n_prod, n_cols), NEG_INF, device=x.device)
    for b in range(plan.n_prod):
        for c in range(b, plan.n_chunks, plan.n_prod):
            c0, c1 = c * plan.chunk_pages, min((c + 1) * plan.chunk_pages, nv)
            for u0 in range(c0, c1, plan.unit_pages):
                u1 = min(u0 + plan.unit_pages, c1)
                units.append((b, c, u0, u1 - u0))
                for p in range(u0, u1):
                    if producer[p] is not None:
                        raise AssertionError(f"page {p} produced twice")
                    producer[p] = b
                    ws[p] = part[p]
                blk_mn[b] = torch.minimum(blk_mn[b], mn[u0:u1].amin(dim=0))
                blk_mx[b] = torch.maximum(blk_mx[b], mx[u0:u1].amax(dim=0))
    if trace is not None:
        trace.update(plan=plan, producer=producer, units=units)
    tot = scan_follow_emulated(ws, plan, trace)
    return _reduce_block(tot, blk_mn.amin(dim=0), blk_mx.amax(dim=0),
                         n_cols, x.device)


def _chain(cols, scale):
    """Per-row sum of ``cols[c] * scale[c]`` as an explicit add chain
    over columns: s = w[0]; s = s + w[c] for c = 1..C-1, each product
    rounded before its add (the order of ``_topk_fold_page``)."""
    s = cols[0] * scale[0]
    for c in range(1, cols.shape[0]):
        s = s + cols[c] * scale[c]
    return s


def _row_scores(x, query, metric: str):
    """Scores of rows x [R, C] against query [C]: the column add chain of
    their products (``cosine``: over max(sqrt(chain(x*x)), 1e-6))."""
    if metric not in TOPK_METRICS:
        raise ValueError(f"metric must be one of {TOPK_METRICS}, "
                         f"got {metric!r}")
    cols = x.t().contiguous()                      # one column per step
    s = _chain(cols, query.reshape(-1).float().to(x.device))
    if metric == "cosine":
        s = s / torch.clamp(torch.sqrt(_chain(cols, cols)), min=1e-6)
    return s


def _topk_rows(x, n_rows: int, query, k: int, metric: str):
    """Score rows x [R, C] (row id = index) against query [C] and keep
    the k best by (score descending, id ascending); rows at or past
    n_rows are empty slots (NEG_INF, BIG_ID).  Returns [8, topk_pad(k)]
    f32: scores on row 0, ids (as f32) on row 1."""
    dev = x.device
    s = _row_scores(x, query, metric)
    pos = torch.arange(x.shape[0], device=dev)
    valid = pos < n_rows
    s = torch.where(valid, s, NEG_INF)
    ids = torch.where(valid, pos.float(), BIG_ID)
    # rows are in id order, so a stable sort keeps ids ascending on ties
    order = torch.sort(s, descending=True, stable=True).indices[:k]
    out = torch.zeros((REDUCE_ROWS, topk_pad(k)), device=dev)
    out[0, :k] = NEG_INF
    out[1, :k] = BIG_ID
    out[0, :order.numel()] = s[order]
    out[1, :order.numel()] = ids[order]
    return out


def topk_scan_ref(pages, page_table, n_rows: int, query, *, k: int,
                  metric: str = "dot", scales=None):
    """Query-scored top-k over an extent's pages: the same pool operands
    as :func:`scan_filter_reduce_ref`; query [n_cols] (or [1, n_cols])
    f32.  ``cosine`` divides each row's dot by max(sqrt(chain(x*x)),
    1e-6) (the query is not normalised)."""
    n_phys, page_rows, n_cols = pages.shape
    nv = n_valid_pages(n_rows, page_rows, page_table.shape[0])
    x = pool_rows(pages, scales, page_table[:nv].long())
    return _topk_rows(x.reshape(-1, n_cols), n_rows, query, k, metric)


def topk_blocks_emulated(pages, page_table, n_rows: int, query, *, k: int,
                         metric: str = "dot", scales=None, n_blocks: int,
                         sort_cap: int = 1024, flush_at: int = None,
                         stats=None):
    """A plain emulation of the CUDA top-k's split (``csrc/isp_scan.cu``,
    ``topk_stream_kernel``), equal to :func:`topk_scan_ref` bit for bit.

    A valid page is ``parts`` units of ``unit = min(page_rows,
    TOPK_UNIT_ROWS)`` rows in row order (the last one shorter), or, on
    the kernel's direct path (:func:`topk_tma_path`), pages of at most
    ``TOPK_GROUP_MAX`` rows go :func:`topk_unit_pages` whole pages a
    unit; block b takes the units [nu*b//n_blocks, nu*(b+1)//n_blocks).
    At each unit's end the rows that beat the block's running k-th best
    (score desc, id asc) join a candidate buffer, sorted in once it holds
    ``flush_at`` (the kernel's: max(k, 32)) or more than ``sort_cap - k -
    row_threads`` (row threads: ``unit`` rounded up to 32); the block's
    sorted k best are its list.  The last block merges the lists a
    position at a time, stopping at the first position where no entry
    beats the k-th best of its last sort; it sorts its candidates in once
    k have gathered (or when the next round might not fit).  ``stats``, a dict, receives the sorts (``flushes``),
    those mid-block (``stream_flushes``), those of a full buffer among
    them (``buffer_full``) and the merge rounds."""
    n_phys, page_rows, n_cols = pages.shape
    nv = n_valid_pages(n_rows, page_rows, page_table.shape[0])
    tma = topk_tma_path(page_rows, n_cols, pages.element_size(),
                        scales is not None)
    group = topk_unit_pages(page_rows, tma)
    unit = group * page_rows if group > 1 else min(page_rows, TOPK_UNIT_ROWS)
    parts = -(-page_rows // unit)
    nu = topk_units(nv, page_rows, tma)
    if not 1 <= n_blocks <= nu:
        raise ValueError(f"n_blocks must be in [1, {nu}], got {n_blocks}")
    x = pool_rows(pages, scales, page_table[:nv].long())
    scores = _row_scores(x.reshape(-1, n_cols), query, metric).tolist()
    row_threads = -(-unit // 32) * 32
    cap = sort_cap - k - row_threads
    if flush_at is None:
        flush_at = max(k, 32)
    if cap < 1 or k + n_blocks > sort_cap:
        raise ValueError(f"sort_cap {sort_cap} too small for k={k}, "
                         f"{row_threads} row threads, {n_blocks} blocks")
    empty = (NEG_INF, int(BIG_ID))

    def key(c):
        return (-c[0], c[1])

    def beats(c, thr):
        return key(c) < key(thr)

    def sort_in(best, pending):
        if stats is not None:
            stats["flushes"] = stats.get("flushes", 0) + 1
        return sorted(best + pending, key=key)[:k]

    lists = []
    for b in range(n_blocks):
        best, pending = [empty] * k, []
        for u in range(nu * b // n_blocks, nu * (b + 1) // n_blocks):
            if group > 1:
                first = u * group * page_rows
                rows = range(first, min(first + unit, nv * page_rows))
            else:
                p, r0 = divmod(u, parts)
                rows = range(p * page_rows + r0 * unit,
                             p * page_rows + min((r0 + 1) * unit, page_rows))
            for pos in rows:
                c = (scores[pos], pos)
                if pos < n_rows and beats(c, best[k - 1]):
                    pending.append(c)
            if len(pending) >= flush_at or len(pending) > cap:
                if stats is not None:
                    stats["stream_flushes"] = stats.get(
                        "stream_flushes", 0) + 1
                    stats["buffer_full"] = stats.get("buffer_full", 0) + (
                        len(pending) > cap)
                best, pending = sort_in(best, pending), []
        if pending:
            best = sort_in(best, pending)
        lists.append(best)
    best, pending = [empty] * k, []
    rounds = 0
    for r in range(k):
        won = [lst[r] for lst in lists if beats(lst[r], best[k - 1])]
        rounds += 1
        if not won:
            break
        pending += won
        if len(pending) >= k or len(pending) + n_blocks > sort_cap - k:
            best, pending = sort_in(best, pending), []
    if pending:
        best = sort_in(best, pending)
    if stats is not None:
        stats["merge_rounds"] = rounds
    out = torch.zeros((REDUCE_ROWS, topk_pad(k)), device=x.device)
    out[0, :k] = torch.tensor([c[0] for c in best], dtype=torch.float32)
    out[1, :k] = torch.tensor([float(c[1]) for c in best])
    return out


def topk_scan_host(data, query, *, page_rows: int, k: int,
                   metric: str = "dot"):
    """The same top-k over a fetched extent data [n_rows, n_cols]:
    bit-identical to the pool version (``page_rows`` only sets the
    pages the pool would hold; empty rows never win)."""
    del page_rows
    return _topk_rows(data.float(), data.shape[0], query, k, metric)


# ---------------------------------------------------------------------------
# embedding bag and row gather (``repro/kernels/embed_agg.py``)
# ---------------------------------------------------------------------------


def _take_rows(table, ids):
    """table[ids] (fp8 rows are taken as bytes: not every indexing
    kernel takes float8)."""
    if table.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return table.view(torch.uint8)[ids].view(table.dtype)
    return table[ids]


def embed_agg_ref(table, indices, weights=None):
    """Sum-pooled lookups: [B, D] f32, out[b] = sum over l = 0..L-1 in
    lookup order of w[b, l] * table[indices[b, l]] (each code widened
    to f32, each product rounded before its add, from 0; unweighted: the
    rows themselves)."""
    b, n_look = indices.shape
    out = torch.zeros((b, table.shape[1]), device=table.device)
    for li in range(n_look):
        row = _take_rows(table, indices[:, li].long()).float()
        if weights is not None:
            row = row * weights[:, li, None].float()
        out = out + row
    return out


def embed_gather_ref(table, indices):
    """Batched row gather: table [V, D] by indices [B, K] -> [B, K, D],
    the table's dtype kept (int32 token blocks stay int32)."""
    return _take_rows(table, indices.long())


# The CUDA kernels' work split (``csrc/embed_agg.cu``).  A row is cut in
# pieces of ``vec`` bytes; a group of ``lanes`` lanes takes a bag (or a
# gathered row), one piece a lane; a row over EMBED_SLICE_PIECES pieces
# is cut in column slices, a group each.  The bag walks its lookups in
# stages of EMBED_STAGE_ROWS rows: lane j < EMBED_STAGE_ROWS of the group
# loads the id (and weight) of row j, which every lane takes by a
# shuffle; two stages are in flight.
EMBED_MAX_PIECE = 16
EMBED_STAGE_ROWS = 8
EMBED_MIN_LANES = EMBED_STAGE_ROWS   # a stage's ids, one a lane
EMBED_SLICE_PIECES = 32
EMBED_BLOCK_THREADS = 128


class EmbedPlan(NamedTuple):
    vec: int        # bytes of a piece: 16, 8, 4, 2 or 1
    pieces: int     # pieces of a row
    lanes: int      # lanes of a group: 8, 16 or 32
    slices: int     # column slices of a row, a group each
    stage: int      # rows of a stage (two in flight)


def embed_align(table) -> int:
    """The alignment, up to 16 bytes, of every row of ``table``: of its
    base pointer and of its row stride in bytes."""
    return math.gcd(table.data_ptr(), table.stride(0) * table.element_size(),
                    EMBED_MAX_PIECE)


def embed_plan(elem_size: int, d: int, align: int) -> EmbedPlan:
    """The embedding kernels' split of a row of ``d`` elements of
    ``elem_size`` bytes whose rows start ``align``-byte aligned (the
    wrapper passes it to ``csrc/embed_agg.cu``, the emulations follow
    it): the widest piece that divides the row bytes and the alignment,
    lanes for a row's pieces (at least a stage's ids, at most a warp)
    and 32-piece slices of a wider row."""
    if align % elem_size:
        raise ValueError(f"rows aligned to {align} bytes hold no "
                         f"{elem_size}-byte elements")
    row = elem_size * d
    vec = math.gcd(row, align, EMBED_MAX_PIECE)
    pieces = row // vec
    if pieces > EMBED_SLICE_PIECES:
        lanes, slices = EMBED_SLICE_PIECES, -(-pieces // EMBED_SLICE_PIECES)
    else:
        lanes = max(EMBED_MIN_LANES, 1 << (pieces - 1).bit_length())
        slices = 1
    return EmbedPlan(vec, pieces, lanes, slices, EMBED_STAGE_ROWS)


def embed_blocks(plan: EmbedPlan, n_rows: int) -> int:
    """Blocks of the launch: a group for each (bag or row, slice)."""
    groups = n_rows * plan.slices
    per_block = EMBED_BLOCK_THREADS // plan.lanes
    return -(-groups // per_block)


def embed_lane_pieces(plan: EmbedPlan):
    """[(slice, lane, first byte, end byte)] of each lane that holds a
    piece of the row: piece slice * EMBED_SLICE_PIECES + lane."""
    out = []
    for s in range(plan.slices):
        for q in range(plan.lanes):
            p = s * EMBED_SLICE_PIECES + q
            if p < plan.pieces:
                out.append((s, q, p * plan.vec, (p + 1) * plan.vec))
    return out


def _slice_bytes(plan: EmbedPlan):
    """(first byte, end byte) of each slice's live lanes."""
    spans = {}
    for s, _, lo, hi in embed_lane_pieces(plan):
        spans[s] = (spans.get(s, (lo,))[0], hi)
    return [spans[s] for s in range(plan.slices)]


def embed_agg_emulated(table, indices, weights=None, *, align=None):
    """A plain emulation of the CUDA bag kernel under :func:`embed_plan`,
    equal to :func:`embed_agg_ref` bit for bit: each slice's lanes read
    their pieces of a row as raw bytes at the row's offset, widen the
    codes to f32 and add the stage's rows in lookup order, each row's id
    and weight taken from the stage lane that loaded them."""
    v, d = table.shape
    es = table.element_size()
    plan = embed_plan(es, d, embed_align(table) if align is None else align)
    raw = table.view(torch.uint8)
    b, n_look = indices.shape
    ids = indices.long()
    w = None if weights is None else weights.float()
    out = torch.empty((b, d), device=table.device)
    for lo, hi in _slice_bytes(plan):
        acc = torch.zeros((b, (hi - lo) // es), device=table.device)
        for l0 in range(0, n_look, plan.stage):
            stage_ids = ids[:, l0:l0 + plan.stage]  # lane j: row l0 + j
            for j in range(stage_ids.shape[1]):
                x = raw[stage_ids[:, j], lo:hi].contiguous().view(
                    table.dtype).float()
                if w is not None:
                    x = x * w[:, l0 + j, None]
                acc = acc + x
        out[:, lo // es:hi // es] = acc
    return out


def embed_gather_emulated(table, indices, *, align=None):
    """The CUDA gather under :func:`embed_plan`: each (row, slice) group
    copies its lanes' pieces of the row's bytes, blind to the dtype."""
    v, d = table.shape
    es = table.element_size()
    plan = embed_plan(es, d, embed_align(table) if align is None else align)
    raw = table.view(torch.uint8)
    rows = indices.reshape(-1).long()
    out = torch.empty((rows.numel(), d * es), dtype=torch.uint8,
                      device=table.device)
    for lo, hi in _slice_bytes(plan):
        out[:, lo:hi] = raw[rows, lo:hi]
    return out.view(table.dtype).reshape(*indices.shape, d)


# ---------------------------------------------------------------------------
# flash attention (``repro/kernels/flash_attention.py``)
# ---------------------------------------------------------------------------


def flash_attention_ref(q, k, v, causal: bool = True):
    """q: [B, H, Sq, D]; k/v: [B, Hkv, Sk, D] (GQA by head grouping).

    The JAX package's oracle (``repro/kernels/ref.py:20``): the causal
    mask keeps ``tril(Sk - Sq)``, aligned to the bottom right, where its
    Pallas kernel aligns it to the top left; the two agree for Sq == Sk,
    the only causal case the kernel's wrapper accepts.  Scores and
    softmax run in f32 (in f64 for f64 inputs, for gradient checks)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    wide = torch.promote_types(q.dtype, torch.float32)   # f32, or f64
    qg = q.reshape(b, hkv, h // hkv, sq, d).to(wide)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(wide)) / math.sqrt(d)
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v)
    return out.reshape(b, h, sq, d)


def flash_attention_lse_ref(q, k, v, causal: bool = True):
    """(out, lse): :func:`flash_attention_ref`'s out and each query row's
    natural-log logsumexp of its scaled, masked scores, [B, H, Sq] f32
    (what the training forward saves for the backward)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    wide = torch.promote_types(q.dtype, torch.float32)   # f32, or f64
    qg = q.reshape(b, hkv, h // hkv, sq, d).to(wide)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(wide)) / math.sqrt(d)
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    lse = torch.logsumexp(logits, dim=-1).reshape(b, h, sq)
    return flash_attention_ref(q, k, v, causal), lse


def flash_attention_bwd_ref(q, k, v, out, lse, dout, causal: bool = True):
    """(dq, dk, dv) of :func:`flash_attention_ref` by the recompute the
    backward kernels do (``csrc/flash_attention_bwd.cu``), on whole
    tensors: P = exp(S * scale - lse) (masked 0), dV = P^T dO,
    dP = dO V^T, Di = rowsum(dO * O), dS = P * (dP - Di),
    dQ = dS K * scale, dK = dS^T Q * scale; dK and dV summed over the
    G heads of a group.  Shapes as :func:`flash_attention_ref`, lse
    [B, H, Sq]."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, g, sq, d)
    dog = dout.reshape(b, hkv, g, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) * scale
    p = torch.exp(s - lse.reshape(b, hkv, g, sq)[..., None])
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        p = torch.where(mask, p, torch.zeros_like(p))
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v)
    di = (dout * out).sum(-1).reshape(b, hkv, g, sq)
    ds = p * (dp - di[..., None])
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
    return dq.reshape(b, h, sq, d), dk, dv


#: keys of a dK/dV block and rows of a dQ block on the backward's
#: tensor-core route (``kMmaRows`` in ``csrc/flash_attention_bwd.cu``)
FLASH_BWD_ROWS = 64


class FlashBwdPlan(NamedTuple):
    """The backward's tensor-core launch at one shape
    (:func:`flash_bwd_plan`): ``dkdv_blocks`` blocks of (batch, head, key
    tile), B * H a key tile (:func:`flash_bwd_dkdv_blocks`), then
    ``dq_blocks`` blocks of (batch, kv head, ``bq`` positions of the G
    heads), B * Hkv a query tile (:func:`flash_bwd_dq_blocks`), in one
    grid; merge tickets and workspace floats (0 at G = 1)."""
    cols: int
    key_tiles: int
    dkdv_blocks: int
    bq: int
    query_tiles: int
    dq_blocks: int
    tickets: int
    workspace: int

    @property
    def blocks(self) -> int:
        """The launch's grid: the dK/dV blocks, then the dQ blocks."""
        return self.dkdv_blocks + self.dq_blocks


def flash_bwd_mma(head_dim: int, group: int) -> bool:
    """Whether the backward takes its tensor-core route (else f32 FMA)."""
    return head_dim <= 128 and group <= FLASH_BWD_ROWS


def flash_bwd_plan(b: int, h: int, hkv: int, sq: int, sk: int,
                   d: int) -> FlashBwdPlan:
    """The tensor-core route's schedule (``MmaCfg``, ``launch_mma``):
    walked tiles of ``cols`` (32 queries or keys up to a head dim of 96
    rounded up to 32, else 16); the G heads' dK/dV shares in a workspace
    [2, G, B, Hkv, Sk, D], merged by the last block of each (batch, kv
    head, key tile) group, one ticket each."""
    group = h // hkv
    cols = 32 if -(-d // 32) * 32 <= 96 else 16
    key_tiles = -(-sk // FLASH_BWD_ROWS)
    bq = FLASH_BWD_ROWS // group
    query_tiles = -(-sq // bq)
    merged = group > 1
    return FlashBwdPlan(cols, key_tiles, b * h * key_tiles, bq, query_tiles,
                        b * hkv * query_tiles,
                        b * hkv * key_tiles if merged else 0,
                        2 * b * h * sk * d if merged else 0)


def flash_bwd_dkdv_walk(plan: FlashBwdPlan, key_tile: int, sq: int,
                        causal: bool):
    """The query tiles (of ``plan.cols``) a dK/dV block of ``key_tile``
    walks, in order: from the key tile's diagonal when causal."""
    t0 = key_tile * FLASH_BWD_ROWS // plan.cols if causal else 0
    return range(t0, -(-sq // plan.cols))


def flash_bwd_dq_walk(plan: FlashBwdPlan, q0: int, sq: int, sk: int,
                      causal: bool):
    """The key tiles (of ``plan.cols``) a dQ block of positions ``[q0,
    q0 + bq)`` walks, in order: up to its last row when causal."""
    kmax = min(q0 + plan.bq, sq, sk) if causal else sk
    return range(-(-kmax // plan.cols))


def flash_bwd_dkdv_blocks(plan: FlashBwdPlan, b: int, h: int):
    """The dK/dV blocks in launch order, (batch, head, key tile): the
    blocks of key tile 0 (the longest walks when causal) first."""
    return [(i // h, i % h, kt) for kt in range(plan.key_tiles)
            for i in range(b * h)]


def flash_bwd_dq_blocks(plan: FlashBwdPlan, b: int, hkv: int):
    """The dQ blocks in launch order, (batch, kv head, first position):
    the last (longest, causal) positions first."""
    return [(i // hkv, i % hkv, (plan.query_tiles - 1 - y) * plan.bq)
            for y in range(plan.query_tiles) for i in range(b * hkv)]


def flash_attention_bwd_emulated(q, k, v, out, lse, dout,
                                 causal: bool = True):
    """The backward's tensor-core route in plain f32 on its plan
    (:func:`flash_bwd_plan`): products by :func:`mm_3xtf32` with lo cut
    (``lo=tf32_cut``, the kernel's ``split_lo_cut``); P =
    exp2(S * log2(e) / sqrt(D) - lse * log2(e)), masked 0; each walked
    tile's share summed on its own and joined to the running sums by f32
    adds, in walk order; each head's dK/dV share summed over its query
    tiles, the G shares then joined head 0 first; dQ over its key tiles
    in order.  (dq, dk, dv) shaped as q, k, v."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    plan = flash_bwd_plan(b, h, hkv, sq, sk, d)
    rows, cols = FLASH_BWD_ROWS, plan.cols
    f32 = torch.float32
    log2e = torch.tensor(1.4426950408889634, dtype=f32)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=f32))
    scale_log2 = log2e * scale
    qh = q.reshape(b, hkv, g, sq, d)
    doh = dout.reshape(b, hkv, g, sq, d)
    lse2 = lse.reshape(b, hkv, g, sq) * log2e
    di = (dout * out).sum(-1).reshape(b, hkv, g, sq)
    pos = torch.arange(sq, device=q.device)

    def mm(x, y):
        return mm_3xtf32(x, y, lo=tf32_cut)
    key = torch.arange(sk, device=q.device)

    def probs(s, i, j):
        """P of scores s [.., len(i), len(j)] (query rows i, keys j)."""
        p = torch.exp2(s * scale_log2 - lse2[..., i][..., :, None])
        if causal:
            p = torch.where(j[None, :] <= i[:, None], p, torch.zeros_like(p))
        return p

    dk_sh = torch.zeros((b, hkv, g, sk, d), dtype=f32, device=q.device)
    dv_sh = torch.zeros_like(dk_sh)
    for kt in range(plan.key_tiles):
        j = key[kt * rows:(kt + 1) * rows]
        kk, vv = k[:, :, None, j], v[:, :, None, j]
        for t in flash_bwd_dkdv_walk(plan, kt, sq, causal):
            i = pos[t * cols:(t + 1) * cols]
            qt, dot = qh[..., i, :], doh[..., i, :]
            pt = probs(mm(kk, qt.transpose(-1, -2)).transpose(-1, -2),
                       i, j).transpose(-1, -2)
            dpt = mm(vv, dot.transpose(-1, -2))
            dst = pt * (dpt - di[..., i][..., None, :])
            dv_sh[..., j, :] += mm(pt, dot)
            dk_sh[..., j, :] += mm(dst, qt)
    dk, dv = dk_sh[:, :, 0], dv_sh[:, :, 0]
    for gi in range(1, g):
        dk = dk + dk_sh[:, :, gi]
        dv = dv + dv_sh[:, :, gi]

    # a row walks the key tiles below its dQ block's kmax
    q0 = pos // plan.bq * plan.bq
    kmax = torch.clamp(q0 + plan.bq, max=min(sq, sk)) if causal else \
        torch.full_like(pos, sk)
    dq = torch.zeros((b, hkv, g, sq, d), dtype=f32, device=q.device)
    for jt in range(-(-sk // cols)):
        j = key[jt * cols:(jt + 1) * cols]
        kt_, vt = k[:, :, None, j], v[:, :, None, j]
        p = probs(mm(qh, kt_.transpose(-1, -2)), pos, j)
        ds = p * (mm(doh, vt.transpose(-1, -2)) - di[..., None])
        walks = (jt * cols < kmax)[:, None]
        dq = torch.where(walks, dq + mm(ds, kt_), dq)
    return dq.reshape(b, h, sq, d) * scale, dk * scale, dv


def tf32_rna(x):
    """``cvt.rna.tf32.f32`` on f32 ``x``: the nearest TF32 value (10
    explicit mantissa bits, the low 13 bits of the f32 zero), ties away
    from zero; for finite inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_cut(x):
    """The TF32 value a tensor core reads from f32 ``x``: its top 19
    bits (the low 13 bits of the f32 zero, toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a, b, lo=tf32_rna):
    """``a @ b`` as the flash kernel's 3xTF32 products compute it: each
    operand split into hi = tf32(x) and lo = tf32(x - hi), then lo*hi +
    hi*lo + hi*hi (each product exact in f32, sums in f32; lo*lo, about
    2^-22 relative, dropped).  ``lo=tf32_cut``: the backward's split,
    x - hi left unrounded and read by the tensor core cut."""
    a_hi = tf32_rna(a)
    a_lo = lo(a - a_hi)
    b_hi = tf32_rna(b)
    b_lo = lo(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def flash_attention_3xtf32(q, k, v, causal: bool = True, *, block_k: int):
    """A plain emulation of the CUDA flash kernel's arithmetic
    (``csrc/flash_attention.cu``) in f32: key tiles of ``block_k``, scores
    ``mm_3xtf32(q, k^T) * log2(e) / sqrt(D)`` masked to -1e30 (causal from
    the top left), an online softmax in base 2, P V by ``mm_3xtf32``,
    out = acc / max(l, 1e-30).  q: [B, H, Sq, D]; k/v: [B, Hkv, Sk, D]."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    f32 = torch.float32
    scale = (torch.tensor(math.log2(math.e), dtype=f32) /
             torch.sqrt(torch.tensor(float(d), dtype=f32)))
    rows = q.reshape(b, hkv, g * sq, d).float()
    pos = torch.arange(sq, device=q.device).repeat(g)
    m = torch.full((b, hkv, g * sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g * sq), device=q.device)
    acc = torch.zeros((b, hkv, g * sq, d), device=q.device)
    for k0 in range(0, sk, block_k):
        kt = k[:, :, k0:k0 + block_k].float()
        vt = v[:, :, k0:k0 + block_k].float()
        s = mm_3xtf32(rows, kt.transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2], device=q.device)
            s = torch.where(cols[None, :] <= pos[:, None], s,
                            torch.full_like(s, NEG_INF))
        mx = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(s - mx[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + mm_3xtf32(p, vt)
        m = mx
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, sq, d)


# ---------------------------------------------------------------------------
# RWKV6 wkv recurrence (``repro/kernels/rwkv_scan.py``,
# ``repro/models/rwkv6.py``)
# ---------------------------------------------------------------------------


def wkv_chunk(r, k, v, logw, u, s0):
    """One chunk of the wkv recurrence, batched over leading dims.

    r/k/logw: [..., C, dk]; v: [..., C, dv]; u: [..., dk] (broadcast over
    the leading dims); s0: [..., dk, dv].  Returns (o [..., C, dv], sC).
    Every exponent is a difference of cumulative log-decays, <= 0; the
    mask comes before the exp, so no masked (positive) exponent is taken.
    """
    cum = torch.cumsum(logw, dim=-2)                    # [..., C, dk] incl. t
    cum_excl = cum - logw                               # through t - 1
    diff = cum_excl[..., :, None, :] - cum[..., None, :, :]   # [..., t, s, dk]
    c = r.shape[-2]
    tri = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    dmat = torch.exp(torch.where(tri[:, :, None], diff,
                                 torch.full_like(diff, float("-inf"))))
    scores = (r[..., :, None, :] * k[..., None, :, :] * dmat).sum(-1)
    diag = (r * u[..., None, :] * k).sum(-1)            # [..., C]
    o = scores @ v + diag[..., None] * v
    o = o + (r * torch.exp(cum_excl)) @ s0
    k2 = k * torch.exp(cum[..., -1:, :] - cum)
    s_c = torch.exp(cum[..., -1, :])[..., None] * s0 + k2.transpose(-1, -2) @ v
    return o, s_c


def wkv_chunked_ref(r, k, v, logw, u, s0, chunk: int = 32):
    """The kernel's plain version: chunks of ``min(chunk, S)`` tokens in
    a Python loop, each vectorised over (B, H).

    r/k/logw: [B, S, H, dk]; v: [B, S, H, dv]; u: [H, dk]; s0:
    [B, H, dk, dv].  Returns (o [B, S, H, dv], sT [B, H, dk, dv])."""
    s = r.shape[1]
    ck = min(chunk, s)
    if s % ck:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {ck}")
    rs, ks, vs, ws = (x.transpose(1, 2) for x in (r, k, v, logw))  # [B,H,S,*]
    state, outs = s0, []
    for c0 in range(0, s, ck):
        part = slice(c0, c0 + ck)
        o, state = wkv_chunk(rs[:, :, part], ks[:, :, part], vs[:, :, part],
                             ws[:, :, part], u, state)
        outs.append(o)
    return torch.cat(outs, dim=2).transpose(1, 2).contiguous(), state


#: the CUDA wkv scan's longest step (one scan segment of 16 lanes)
WKV_MAX_STEP = 16


def wkv_step_tokens(chunk: int) -> int:
    """Tokens a step of the CUDA wkv scan (``csrc/rwkv_scan.cu``): the
    largest divisor of ``chunk`` up to ``WKV_MAX_STEP``."""
    step = min(chunk, WKV_MAX_STEP)
    while chunk % step:
        step -= 1
    return step


def wkv_mma_products(dk: int, dv: int, step: int) -> bool:
    """Whether the CUDA wkv scan runs its products as 3xTF32 ``mma.sync``
    (the 64 x 64 instantiation, steps of a multiple of 8 tokens) rather
    than f32 FMAs."""
    return dk == 64 and dv == 64 and step % 8 == 0


def wkv_steps_emulated(r, k, v, logw, u, s0, chunk: int = 32):
    """A plain emulation of the CUDA wkv scan's arithmetic: steps of
    ``wkv_step_tokens(min(chunk, S))`` tokens, log-decays scaled by
    log2(e) in f32, their cumulative sums kept to double precision (the
    kernel's double-float scans) and every exponent a difference of two
    of them rounded to f32, exps as 2^x, the scores of a step's pairs
    s < t as dots of rows anchored at each level of the step's index bits
    (a pair at level b, its highest differing bit, anchored at the last
    token of the lower half of its 2^(b+1)-block), then o = [A | r *
    2^cx] [v ; S] and S <- 2^cum[-1] S + (k * 2^(cum[-1] - cum))^T v, in
    f32; the two products as :func:`mm_3xtf32` where the kernel runs
    them on the tensor cores (:func:`wkv_mma_products`).  The kernel's
    ex2.approx is within 2 ulp of ``exp2`` and its sums run in another
    order, so it is held to this within a tolerance, not bit for bit.
    Same operands and result as :func:`wkv_chunked_ref`."""
    b, s, h, dk = r.shape
    ck = min(chunk, s)
    if s % ck:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {ck}")
    step = wkv_step_tokens(ck)
    mm = (mm_3xtf32 if wkv_mma_products(dk, v.shape[-1], step)
          else torch.matmul)
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    rs, ks, vs, ws = (x.transpose(1, 2).float() for x in (r, k, v, logw))
    state, outs = s0.float(), []
    tri = torch.ones((step, step), dtype=torch.bool,
                     device=r.device).tril(-1)
    idx = torch.arange(step, device=r.device)
    for c0 in range(0, s, step):
        part = slice(c0, c0 + step)
        rr, kk, vv = rs[:, :, part], ks[:, :, part], vs[:, :, part]
        w2 = ws[:, :, part] * log2e
        cum = torch.cumsum(w2.double(), dim=-2)         # [B, H, L, dk]
        cx = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]],
                       dim=-2)                          # the sum before t
        # pair s < t at level b (its highest differing index bit): the dot
        # of r[t] 2^(P[t-1] - P[m]) and k[s] 2^(P[m] - P[s]), m the last
        # token of the lower half of its 2^(b+1)-block (b = 0: 2^0)
        a = torch.diag_embed((rr * u[None, :, None, :] * kk).sum(-1))
        for b in range(max(step - 1, 0).bit_length()):
            level = tri & (((idx[:, None] ^ idx[None, :]) >> b) == 1)
            if b == 0:
                r_hat, k_hat = rr, kk
            else:
                m_t = ((idx >> b) << b) - 1              # t in the upper half
                m_s = torch.clamp(idx | ((1 << b) - 1), max=step - 1)
                r_hat = rr * torch.exp2((cx - cum[..., m_t.clamp(min=0),
                                                  :]).float())
                k_hat = kk * torch.exp2((cum[..., m_s, :] - cum).float())
            a = a + torch.where(level, r_hat @ k_hat.transpose(-1, -2),
                                torch.zeros((), dtype=a.dtype))
        r_dec = rr * torch.exp2(cx.float())
        outs.append(mm(torch.cat([a, r_dec], dim=-1),
                       torch.cat([vv, state], dim=-2)))
        k_dec = kk * torch.exp2((cum[..., -1:, :] - cum).float())
        state = (torch.exp2(cum[..., -1, :].float())[..., None] * state +
                 mm(k_dec.transpose(-1, -2), vv))
    return torch.cat(outs, dim=2).transpose(1, 2).contiguous(), state


def wkv_step(r, k, v, logw, u, state):
    """One-token recurrence.  r/k/logw: [B, H, dk]; v: [B, H, dv]; u:
    [H, dk]; state: [B, H, dk, dv].  Returns (o [B, H, dv], new state)."""
    kv = k[..., :, None] * v[..., None, :]              # [B, H, dk, dv]
    o = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None] * kv)
    return o, torch.exp(logw)[..., None] * state + kv


def wkv_ref(r, k, v, logw, u, s0):
    """Per-token oracle of the chunked form (``repro/kernels/ref.py:180``)."""
    state, outs = s0, []
    for t in range(r.shape[1]):
        o, state = wkv_step(r[:, t], k[:, t], v[:, t], logw[:, t], u, state)
        outs.append(o)
    return torch.stack(outs, dim=1), state


# ---------------------------------------------------------------------------
# RWKV6 wkv backward (``csrc/rwkv_scan_bwd.cu``; the JAX package takes this
# gradient by autodiff of its plain ``wkv_chunked``, ``repro/models/
# rwkv6.py:56``: there is no Pallas backward)
# ---------------------------------------------------------------------------


def wkv_states_ref(k, v, logw, s0, step: int):
    """The state at the start of every run of ``step`` tokens: [B, H,
    S / step, dk, dv] (entry 0 is ``s0``), by the chunk form's state
    update.  k/logw: [B, S, H, dk]; v: [B, S, H, dv]; s0: [B, H, dk,
    dv].  What the forward kernel's states variant writes."""
    s = k.shape[1]
    if s % step:
        raise ValueError(f"sequence length {s} is not a multiple of {step}")
    ks, vs, ws = (x.transpose(1, 2) for x in (k, v, logw))     # [B, H, S, *]
    state, out = s0, []
    for c0 in range(0, s, step):
        out.append(state)
        part = slice(c0, c0 + step)
        cum = torch.cumsum(ws[:, :, part], dim=-2)
        k2 = ks[:, :, part] * torch.exp(cum[..., -1:, :] - cum)
        state = (torch.exp(cum[..., -1, :])[..., None] * state +
                 k2.transpose(-1, -2) @ vs[:, :, part])
    return torch.stack(out, dim=2)


def wkv_chunked_bwd_ref(r, k, v, logw, u, s0, do, dsT, chunk: int = 32):
    """Gradient of :func:`wkv_chunked_ref` (o, sT) with respect to r, k,
    v, logw, u and s0, given do [B, S, H, dv] and dsT [B, H, dk, dv]:
    (dr, dk, dv, dlogw [B, S, H, *], du [H, dk], ds0 [B, H, dk, dv]).

    Computed explicitly, not by autograd: a forward pass for the state
    at each chunk start, then the chunks in reverse, carrying G, the
    gradient of the state after the chunk (G = dsT after the last).  In
    a chunk with cumulative log-decays cum (inclusive) and cx = cum -
    logw, D[t, s] = exp(cx[t] - cum[s]) for s < t (masked before the
    exp), A[t, s] = sum_i r k D and A[t, t] = r u k, dP = dO V^T:
      dv = A^T dO + (k exp(cum[-1] - cum)) G
      dr' = exp(cx) (dO S0^T) + sum_{s<t} dP[t, s] k[s] D[t, s]
      dk' = exp(cum[-1] - cum) (V G^T) + sum_{t>s} dP[t, s] r[t] D[t, s]
      dr = dr' + u k dP[t, t];  dk = dk' + u r dP[t, t]
      du += sum_t r k dP[t, t]  (then summed over the batch, in order)
      G <- exp(cum[-1]) G + (r exp(cx))^T dO
    and dlogw by the gated-linear-attention identity, with no division
    by a decay: r[t] scales as exp(cx[t]) and k[s] as exp(-cum[s]), so
    dcum[t] = r[t+1] dr'[t+1] - k[t] dk'[t] (+ rowsum(S_end * G_end) at
    the chunk's last token), and dlogw[t] is its suffix sum over the
    chunk."""
    b, s, h, dk = r.shape
    ck = min(chunk, s)
    if s % ck:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {ck}")
    n = s // ck
    rs, ks, vs, ws, dos = (x.transpose(1, 2) for x in (r, k, v, logw, do))
    starts = wkv_states_ref(k, v, logw, s0, ck)                 # [B,H,N,..]
    last = slice(s - ck, s)
    cum = torch.cumsum(ws[:, :, last], dim=-2)
    s_end = (torch.exp(cum[..., -1, :])[..., None] * starts[:, :, -1] +
             (ks[:, :, last] * torch.exp(cum[..., -1:, :] - cum))
             .transpose(-1, -2) @ vs[:, :, last])
    g = dsT
    rho = (s_end * g).sum(-1)                                   # [B, H, dk]
    tri = torch.ones((ck, ck), dtype=torch.bool, device=r.device).tril(-1)
    grads = {name: [None] * n for name in ("r", "k", "v", "w")}
    du = torch.zeros_like(rs[:, :, 0])                          # [B, H, dk]
    for ci in reversed(range(n)):
        part = slice(ci * ck, (ci + 1) * ck)
        rr, kk, vv, ww, oo = (x[:, :, part] for x in (rs, ks, vs, ws, dos))
        s0c = starts[:, :, ci]
        cum = torch.cumsum(ww, dim=-2)
        cx = cum - ww
        diff = cx[..., :, None, :] - cum[..., None, :, :]       # [.., t, s, dk]
        dmat = torch.exp(torch.where(tri[:, :, None], diff,
                                     torch.full_like(diff, float("-inf"))))
        dp = oo @ vv.transpose(-1, -2)                          # [.., t, s]
        a = (rr[..., :, None, :] * kk[..., None, :, :] * dmat).sum(-1)
        a = a + torch.diag_embed((rr * u[:, None, :] * kk).sum(-1))
        kdec = torch.exp(cum[..., -1:, :] - cum)
        grads["v"][ci] = a.transpose(-1, -2) @ oo + (kk * kdec) @ g
        pd = dp[..., None] * dmat                               # [.., t, s, dk]
        dr_nb = (torch.exp(cx) * (oo @ s0c.transpose(-1, -2)) +
                 (pd * kk[..., None, :, :]).sum(-2))
        dk_nb = (kdec * (vv @ g.transpose(-1, -2)) +
                 (pd * rr[..., :, None, :]).sum(-3))
        dc = -kk * dk_nb
        dc[..., :-1, :] += rr[..., 1:, :] * dr_nb[..., 1:, :]
        dc[..., -1, :] += rho
        grads["w"][ci] = dc.flip(-2).cumsum(-2).flip(-2)
        dpd = dp.diagonal(dim1=-2, dim2=-1)[..., None]          # [.., t, 1]
        grads["r"][ci] = dr_nb + u[:, None, :] * kk * dpd
        grads["k"][ci] = dk_nb + u[:, None, :] * rr * dpd
        du = du + (rr * kk * dpd).sum(-2)
        g = (torch.exp(cum[..., -1, :])[..., None] * g +
             (rr * torch.exp(cx)).transpose(-1, -2) @ oo)
        rho = (s0c * g).sum(-1)
    dr, dk_, dv, dw = (torch.cat(grads[x], dim=2).transpose(1, 2).contiguous()
                       for x in ("r", "k", "v", "w"))
    return dr, dk_, dv, dw, du.sum(0), g


def wkv_grad_states_ref(r, logw, do, dsT, step: int):
    """The backward kernel's state pass (``csrc/rwkv_scan_bwd.cu``): the
    gradient of the state after every run of ``step`` tokens, walked in
    reverse from ``dsT`` by G <- 2^cum[-1] G + (r * 2^cx)^T dO, with the
    log-decays scaled by log2(e) in f32 and summed in double, each
    exponent (a cumulative sum, <= 0) rounded to f32, the update in f32.
    Returns (gs [B, H, S / step, dk, dv], entry c the gradient of the state
    after step c (entry -1 is ``dsT``), ds0).  r/logw: [B, S, H, dk]; do:
    [B, S, H, dv]; dsT: [B, H, dk, dv]."""
    b, s, h, dk = r.shape
    if s % step:
        raise ValueError(f"sequence length {s} is not a multiple of {step}")
    n = s // step
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    rr, ww, oo = (x.float().transpose(1, 2).reshape(b, h, n, step, -1)
                  for x in (r, logw, do))
    cum = torch.cumsum((ww * log2e).double(), dim=-2)           # inclusive
    cx = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]],
                   dim=-2)                                      # before t
    r_dec = rr * torch.exp2(cx.float())
    wl = torch.exp2(cum[..., -1, :].float())[..., None]         # [B,H,N,dk,1]
    g, out = dsT.float(), [None] * n
    for ci in reversed(range(n)):
        out[ci] = g
        g = wl[:, :, ci] * g + r_dec[:, :, ci].transpose(-1, -2) @ oo[:, :, ci]
    return torch.stack(out, dim=2), g


def wkv_bwd_chunks_emulated(r, k, v, logw, u, states, do, dsT):
    """A plain emulation of the CUDA wkv backward's plan
    (``csrc/rwkv_scan_bwd.cu``), in steps of S / states.shape[2] tokens:

    * the state pass, :func:`wkv_grad_states_ref`: the gradient of the
      state after every step, walked in reverse (the only sequential
      part), and ds0;
    * the chunk pass, every step at once (a CUDA block each), from its
      starting state (``states``, what the forward kernel's states
      variant saves) and the gradient of the state after it: log-decays
      scaled by log2(e) in f32 and summed in double, every exponent a
      difference of two such sums rounded to f32, exps as 2^x; the scores
      A and dP = dO V^T; dV = [A^T | k~] [dO ; G] (one product); dr' =
      2^cx (dO S0^T) + the pair sums, dk' = 2^(cum[-1] - cum) (V G^T) +
      the pair sums, the three products as :func:`mm_3xtf32` where the
      kernel runs them on the tensor cores (:func:`wkv_mma_products`);
      the end state's dlogw term rowsum(S_end * G) with S_end rebuilt as
      2^cum[-1] S0 + k~^T V, that is 2^cum[-1] rowsum(S0 * G) + sum_t k
      dk'_state (no read of the state after the step); dlogw by one walk
      a column from the step's last token back; dr, dk and the step's du
      share (its tokens summed from the last back);
    * du: each (batch, head)'s shares from the last step back, then the
      batch in order.

    The kernel's ex2.approx is within 2 ulp of ``exp2`` and its sums run
    in another order, so it is held to this within a tolerance.  Same
    results as :func:`wkv_chunked_bwd_ref`."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    n = states.shape[2]
    step = s // n
    mm = mm_3xtf32 if wkv_mma_products(dk, dv, step) else torch.matmul
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    g_end, ds0 = wkv_grad_states_ref(r, logw, do, dsT, step)
    rr, kk, vv, ww, oo = (x.float().transpose(1, 2).reshape(b, h, n, step,
                                                            -1)
                          for x in (r, k, v, logw, do))
    s0 = states.float()
    cum = torch.cat([torch.zeros_like(ww[..., :1, :]).double(),
                     torch.cumsum((ww * log2e).double(), dim=-2)],
                    dim=-2)                                     # [.., L+1, dk]
    cx, cin = cum[..., :-1, :], cum[..., 1:, :]                 # before / incl. t
    tri = torch.ones((step, step), dtype=torch.bool,
                     device=r.device).tril(-1)
    ex = torch.where(tri[:, :, None],
                     cx[..., :, None, :] - cin[..., None, :, :],
                     torch.zeros((), dtype=torch.float64))
    dmat = torch.where(tri[:, :, None], torch.exp2(ex.float()),
                       torch.zeros((), dtype=torch.float32))
    dp = oo @ vv.transpose(-1, -2)
    uu = u.float()[:, None, None, :]
    a = (rr[..., :, None, :] * kk[..., None, :, :] * dmat).sum(-1)
    a = a + torch.diag_embed((rr * uu * kk).sum(-1))
    kdec = torch.exp2((cum[..., -1:, :] - cin).float())
    dv_ = mm(torch.cat([a.transpose(-1, -2), kk * kdec], dim=-1),
             torch.cat([oo, g_end], dim=-2))
    drs = torch.exp2(cx.float()) * mm(oo, s0.transpose(-1, -2))
    dks = kdec * mm(vv, g_end.transpose(-1, -2))
    pd = dp[..., None] * dmat
    drx = drs + (pd * kk[..., None, :, :]).sum(-2)
    dkx = dks + (pd * rr[..., :, None, :]).sum(-3)
    rho = (torch.exp2(cum[..., -1, :].float()) * (s0 * g_end).sum(-1) +
           (kk * dks).sum(-2))
    acc, dw = rho, [None] * step
    for t in reversed(range(step)):
        if t + 1 < step:
            acc = acc + rr[..., t + 1, :] * drx[..., t + 1, :]
        acc = acc - kk[..., t, :] * dkx[..., t, :]
        dw[t] = acc
    dpd = dp.diagonal(dim1=-2, dim2=-1)[..., None]
    share = torch.zeros_like(rr[..., 0, :])                     # [B, H, N, dk]
    for t in reversed(range(step)):
        share = share + rr[..., t, :] * kk[..., t, :] * dpd[..., t, :]
    per_bh = share[:, :, n - 1]
    for ci in reversed(range(n - 1)):
        per_bh = per_bh + share[:, :, ci]
    du = per_bh[0]
    for bb in range(1, b):
        du = du + per_bh[bb]

    def back(x):
        return x.reshape(b, h, s, -1).transpose(1, 2).contiguous()
    return (back(drx + uu * kk * dpd), back(dkx + uu * rr * dpd), back(dv_),
            back(torch.stack(dw, dim=-2)), du, ds0)
