"""Tiered paged KV cache on torch tensors.

The port of ``repro.core.kv_tier``, split the same way along the
host/device boundary:

  * :class:`PageStore` — device-resident storage: one *stacked* pair of
    tensors ``[n_layers, hbm_pages, page, n_kv_heads, head_dim]`` (plus
    per-slot f32 scales for quantized pages).  Unlike the JAX store,
    which is immutable and replaced after every jitted step, this store
    is **updated in place**: appends, page-ins, copy-on-write splits and
    token writes mutate its tensors, and :meth:`PageStore.device_state`
    hands out views of them.
  * :class:`PageTableManager` — host-side policy (LRU tiering, pinning,
    prefetch, stats, the content-addressed prefix page cache), a copy of
    the JAX package's numpy/hashlib class.  It reaches the store only
    through ``read_page``/``write_page``/``copy_page``/``page_bytes``/
    ``format_key``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

#: accepted values of the ``page_dtype`` knob: ``fp32`` stores pages at
#: the store's compute dtype; ``int8``/``fp8`` store quantized codes with
#: a parallel per-slot, per-head f32 scale array.
PAGE_DTYPES = ("fp32", "int8", "fp8")

#: version tag mixed into every prefix-cache digest (same as the JAX
#: store's, so both derive the same digests from the same tokens)
PAGE_FORMAT_VERSION = 2

_CODE = {"int8": (torch.int8, 127.0), "fp8": (torch.float8_e4m3fn, 448.0)}


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``float32`` (numpy/JAX spelling)."""
    return str(dtype).rsplit(".", 1)[-1]


def quantize_page_kv(x, qmax: float, code_dtype):
    """Symmetric per-slot (per-token), per-head quantization of KV.

    x: [..., D] float -> (codes [..., D] ``code_dtype``, scale [...]
    f32), scale = amax/qmax clamped away from zero.  int8 rounds half to
    even, then clips to +-qmax; fp8 clips to +-qmax, then the cast
    rounds.
    """
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / qmax
    y = xf / scale[..., None]
    if code_dtype == torch.int8:
        codes = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        codes = torch.clamp(y, -qmax, qmax).to(code_dtype)
    return codes, scale


def dequantize_page_kv(codes, scale):
    """Exact inverse map: codes [..., D] x scale [...] -> f32 [..., D]."""
    return codes.float() * scale[..., None]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """fp8 tensors are indexed as bytes: not every indexing kernel takes
    float8."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def write_slots(st: Dict[str, torch.Tensor], rows, offs, k_new, v_new,
                qmax: float = 0.0):
    """In-place write of one KV position per row into a per-layer page
    state ``{"k", "v"[, "ks", "vs"]}``: ``st["k"][rows[i], offs[i]] =
    k_new[i]``.  Quantized states (with ``"ks"``) quantize first, so
    codes and scales land together.  k_new/v_new: [N, Hkv, D];
    rows/offs: [N] integer tensors."""
    idx = (rows.long(), offs.long())
    if "ks" in st:
        kq, ks = quantize_page_kv(k_new, qmax, st["k"].dtype)
        vq, vs = quantize_page_kv(v_new, qmax, st["v"].dtype)
        _bytes(st["k"]).index_put_(idx, _bytes(kq))
        _bytes(st["v"]).index_put_(idx, _bytes(vq))
        st["ks"].index_put_(idx, ks)
        st["vs"].index_put_(idx, vs)
        return
    st["k"].index_put_(idx, k_new.to(st["k"].dtype))
    st["v"].index_put_(idx, v_new.to(st["v"].dtype))


@dataclasses.dataclass
class KVTierStats:
    page_ins: int = 0
    page_outs: int = 0
    hits: int = 0
    misses: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    prefetch_hits: int = 0
    # prefix page cache (content-addressed sharing)
    prefix_hits: int = 0        # pages mapped by sharing, not prefill
    prefix_tokens: int = 0      # prompt tokens whose KV was never computed
    cow_splits: int = 0         # shared pages privatized before a write
    # fused-horizon partial commit: reserved pages whose appends were
    # rejected (EOS, budget) and returned
    horizon_pages_rolled_back: int = 0
    # elastic drain: pages moved device-to-device between shards
    migrated_out: int = 0
    migrated_in: int = 0


class PageStore:
    """Device-resident stacked KV pages, updated in place.

    ``k_pages``/``v_pages``: [n_layers, hbm_pages, page, n_kv_heads,
    head_dim] views; layer ``li`` of physical page ``p`` is
    ``k_pages[li, p]``, and ``layer_state(li)`` is the per-layer slice
    the paged-attention kernel reads.  Quantized stores (``page_dtype``
    int8/fp8) hold codes plus ``k_scale``/``v_scale`` [n_layers,
    hbm_pages, page, n_kv_heads] f32 through the whole page lifecycle.

    The tensors behind the views hold one more page, past the window:
    :meth:`append` sends the rows whose target is the sentinel
    ``hbm_pages`` there, which gives JAX's ``.at[].set(mode="drop")``
    without a device-to-host sync.  No page table ever names it.
    """

    def __init__(self, *, n_layers: int, page_size: int, hbm_pages: int,
                 n_kv_heads: int, head_dim: int, dtype=torch.float32,
                 page_dtype: str = "fp32", device="cuda"):
        if page_dtype not in PAGE_DTYPES:
            raise ValueError(f"page_dtype must be one of {PAGE_DTYPES}, "
                             f"got {page_dtype!r}")
        self.device = resolve_device(device)
        self.n_layers = n_layers
        self.page = page_size
        self.hbm_pages = hbm_pages
        self.hkv = n_kv_heads
        self.hd = head_dim
        self.dtype = dtype
        self.page_dtype = page_dtype
        self.quantized = page_dtype in _CODE
        self.code_dtype, self.qmax = _CODE.get(page_dtype, (dtype, 0.0))
        shape = (n_layers, hbm_pages + 1, page_size, n_kv_heads, head_dim)
        self._bufs = {"k": torch.zeros(shape, dtype=self.code_dtype,
                                       device=self.device),
                      "v": torch.zeros(shape, dtype=self.code_dtype,
                                       device=self.device)}
        if self.quantized:
            for name in ("ks", "vs"):
                self._bufs[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                               device=self.device)

    # -- views ---------------------------------------------------------------

    @property
    def k_pages(self) -> torch.Tensor:
        return self._bufs["k"][:, :self.hbm_pages]

    @property
    def v_pages(self) -> torch.Tensor:
        return self._bufs["v"][:, :self.hbm_pages]

    @property
    def k_scale(self) -> Optional[torch.Tensor]:
        return self._bufs["ks"][:, :self.hbm_pages] if self.quantized else None

    @property
    def v_scale(self) -> Optional[torch.Tensor]:
        return self._bufs["vs"][:, :self.hbm_pages] if self.quantized else None

    @property
    def format_key(self) -> str:
        """Identity of the page layout: page dtype + the full-precision
        base dtype + format version, spelled as the JAX store spells it
        (``kvpage:v2:fp32:float32``).  Mixed into every prefix-cache
        digest so pages of one format can never alias another's."""
        return (f"kvpage:v{PAGE_FORMAT_VERSION}:{self.page_dtype}:"
                f"{_dtype_name(self.dtype)}")

    @staticmethod
    def stacked_page_bytes(*, n_layers: int, page_size: int,
                           n_kv_heads: int, head_dim: int,
                           dtype=torch.float32,
                           page_dtype: str = "fp32") -> int:
        """Bytes of one stacked page (k+v, all layers, scales included)
        without building a store."""
        code = _CODE[page_dtype][0] if page_dtype in _CODE else dtype
        n = n_layers * page_size * n_kv_heads
        per = n * head_dim * code.itemsize
        if page_dtype in _CODE:
            per += n * 4                      # per-slot per-head f32 scale
        return int(per) * 2

    def page_bytes(self) -> int:
        """Bytes of one stacked page (k+v, all layers), dtype-aware."""
        return self.stacked_page_bytes(
            n_layers=self.n_layers, page_size=self.page,
            n_kv_heads=self.hkv, head_dim=self.hd, dtype=self.dtype,
            page_dtype=self.page_dtype)

    # -- host/device transfers (management path, between steps) -------------

    def read_page(self, phys: int) -> Tuple[torch.Tensor, ...]:
        """Device -> host: one stacked page [n_layers, page, hkv, hd] x2
        (plus the scale slices when quantized), as CPU tensors.  The
        tuple is opaque to callers: pass it back to :meth:`write_page`."""
        return tuple(self._bufs[n][:, phys].to("cpu", copy=True)
                     for n in self._bufs)

    def write_page(self, phys: int, k, v, k_scale=None, v_scale=None):
        """Host -> device: restore one stacked page (codes + scales)."""
        src = {"k": k, "v": v, "ks": k_scale, "vs": v_scale}
        for name, buf in self._bufs.items():
            buf[:, phys].copy_(torch.as_tensor(src[name]))

    def device_state(self) -> Dict[str, torch.Tensor]:
        """The store as the dict the serving steps read and write:
        {"k", "v"} plus {"ks", "vs"} when quantized, views of the live
        tensors with the layer axis leading."""
        return {n: b[:, :self.hbm_pages] for n, b in self._bufs.items()}

    def adopt(self, state: Dict[str, torch.Tensor]):
        """Install a state dict shaped like :meth:`device_state`.  The
        port's steps write in place, so their state is already the
        store's and nothing is copied."""
        for name, view in self.device_state().items():
            if state[name].data_ptr() != view.data_ptr():
                view.copy_(state[name])

    def copy_page(self, src: int, dst: int):
        """Device-side stacked-page copy (the copy-on-write split);
        quantized pages copy codes AND scales."""
        for buf in self._bufs.values():
            buf[:, dst].copy_(buf[:, src])

    def append(self, li: int, rows, offs, k_new, v_new):
        """In-place append of one position per row into layer ``li``
        (quantized at write time when the store is).  Rows whose target
        is ``hbm_pages`` (the sentinel) are dropped: they land in the
        page past the window.  k_new/v_new: [N, Hkv, D]; rows/offs: [N]."""
        write_slots({n: b[li] for n, b in self._bufs.items()}, rows, offs,
                    k_new, v_new, self.qmax)

    def write_token(self, li: int, phys: int, off: int, k_tok, v_tok):
        """Single-position write (eager paths): quantizes first when the
        store is quantized.  k_tok/v_tok: [hkv, hd]."""
        idx = torch.tensor([phys], device=self.device)
        write_slots(self.layer_state(li), idx, torch.tensor(
            [off], device=self.device), k_tok[None], v_tok[None], self.qmax)

    def layer_state(self, li: int) -> Dict[str, torch.Tensor]:
        """Per-layer slice of :meth:`device_state` (contiguous views the
        kernel reads)."""
        return {n: b[li, :self.hbm_pages] for n, b in self._bufs.items()}


class PageTableManager:
    """Host-side page-table policy for a :class:`PageStore`.

    Logical pages are (seq_id, page_idx).  The manager decides *where*
    KV lives (HBM window vs host tier) and hands the jitted step a dense
    ``page_table`` of physical ids; it never touches KV values except to
    move whole stacked pages on eviction/page-in.

    **Pool sharding** (``n_shards > 1``): the physical window is split
    into equal contiguous ranges — shard ``s`` (one DockerSSD node of
    the storage pool) owns physical ids ``[s*pps, (s+1)*pps)`` plus its
    own host ("flash") tier.  ``shard_of(seq_id, page_idx)`` is the
    placement policy: the default stripes a sequence's logical pages
    round-robin across shards (the D-Cache sequence-sharded extent);
    ``runtime.pool.PoolServer`` substitutes per-sequence placement.
    Allocation, LRU eviction and page-in never cross a shard boundary —
    each node tiers against its own window — and every counter is kept
    twice: globally (``stats``) and per shard (``shard_stats``), so the
    pool's aggregate telemetry is exactly the sum of its nodes'.
    """

    def __init__(self, store: PageStore, *, n_shards: int = 1,
                 shard_of=None):
        self.store = store
        self.page = store.page
        self.hbm_pages = store.hbm_pages
        if store.hbm_pages % n_shards:
            raise ValueError(f"hbm_pages={store.hbm_pages} not divisible "
                             f"by n_shards={n_shards}")
        self.n_shards = n_shards
        self.pages_per_shard = store.hbm_pages // n_shards
        self.shard_of = shard_of or (lambda seq, pi: pi % n_shards)
        # per-shard free lists: shard s owns [s*pps, (s+1)*pps)
        self._free: List[List[int]] = [
            list(range(s * self.pages_per_shard,
                       (s + 1) * self.pages_per_shard))
            for s in range(n_shards)]
        self._dead_shards: set = set()
        # parked shards (elastic drain): the window is intact but the
        # node has left the serving set — allocation refuses it until a
        # re-join unparks it.  Distinct from dead: parked data survived
        # (it was migrated off), dead data is gone.
        self._parked_shards: set = set()
        # logical -> physical, LRU-ordered.  Several logical keys may map
        # to ONE physical page (prefix sharing); _rc counts the sharers.
        self._resident: "OrderedDict[Tuple[int,int], int]" = OrderedDict()
        self._rc: Dict[int, int] = {}
        # host tier: lkey -> the opaque tuple store.read_page returned
        # (codes + scales for quantized stores — spilled bytes stay
        # quantized)
        self._host: Dict[Tuple[int, int], Tuple[np.ndarray, ...]] = {}
        self._lengths: Dict[int, int] = {}
        self._prefetched: set = set()
        self._pinned: set = set()
        # prefix page cache: per-shard content-addressed index
        # digest(tokens[:end]) -> physical page whose KV covers exactly
        # that prefix's slice; _page_digest is the reverse map used to
        # invalidate entries when a page leaves HBM; _cached holds
        # registered pages no sequence references any more — they stay
        # resident as reclaimable cache (LRU order) so an identical
        # prompt later still hits warm.
        self._prefix_index: List[Dict[bytes, int]] = [
            {} for _ in range(n_shards)]
        # every digest is keyed by the store's page-format identity
        # (dtype + layout version): a server restarted with a different
        # page_dtype computes disjoint digests, so match_prefix can
        # never admit a share against pages of the wrong format
        # (blake2b keys cap at 64 bytes)
        self._format_key = store.format_key.encode()[:64]
        self._page_digest: Dict[int, bytes] = {}
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self.stats = KVTierStats()
        self.shard_stats: List[KVTierStats] = [KVTierStats()
                                               for _ in range(n_shards)]

    # -- shard helpers -------------------------------------------------------

    def shard_of_phys(self, phys: int) -> int:
        return phys // self.pages_per_shard

    def _bump(self, shard: int, field: str, n: int = 1):
        setattr(self.stats, field, getattr(self.stats, field) + n)
        ss = self.shard_stats[shard]
        setattr(ss, field, getattr(ss, field) + n)

    # -- sequence lifetime ---------------------------------------------------

    def add_sequence(self, seq_id: int):
        self._lengths[seq_id] = 0

    def length(self, seq_id: int) -> int:
        return self._lengths[seq_id]

    def set_length(self, seq_id: int, n: int):
        self._lengths[seq_id] = n

    def free_sequence(self, seq_id: int) -> int:
        """Release every page a sequence holds, in both tiers.  Returns
        the number of logical pages released; physical slots whose last
        sharer this was are immediately reusable by a waiting request
        (registered prefix pages stay resident as reclaimable cache)."""
        freed = 0
        for lkey in [k for k in list(self._resident) if k[0] == seq_id]:
            self._unmap(lkey)
            freed += 1
        for lkey in [k for k in list(self._host) if k[0] == seq_id]:
            self._host.pop(lkey)
            self._prefetched.discard(lkey)
            freed += 1
        self._lengths.pop(seq_id, None)
        return freed

    # -- capacity accounting (admission control) -----------------------------

    def pages_needed(self, n_tokens: int) -> int:
        """Pages a sequence of ``n_tokens`` occupies."""
        return -(-max(n_tokens, 1) // self.page)

    @property
    def free_pages(self) -> int:
        """Immediately-allocatable pages: the free lists plus the
        unreferenced prefix-cache pages (reclaimed on demand)."""
        return sum(len(f) for f in self._free) + len(self._cached)

    def shard_free_pages(self, shard: int) -> int:
        return len(self._free[shard]) + sum(
            1 for p in self._cached if self.shard_of_phys(p) == shard)

    @property
    def resident_pages(self) -> int:
        """Distinct physical pages some sequence maps (shared pages
        count once; unreferenced cache pages don't count)."""
        return len(self._rc)

    @property
    def cached_pages(self) -> int:
        """Registered prefix pages no sequence references — resident,
        reclaimable, waiting for a warm admission."""
        return len(self._cached)

    @property
    def host_pages(self) -> int:
        return len(self._host)

    def residency(self) -> float:
        return len(self._rc) / self.hbm_pages

    def sequences_on_shard(self, shard: int) -> set:
        """Every sequence with a page (either tier) homed on ``shard``."""
        seqs = {k[0] for k, phys in self._resident.items()
                if self.shard_of_phys(phys) == shard}
        seqs |= {k[0] for k in self._host
                 if self.shard_of(k[0], k[1]) == shard}
        return seqs

    def resident_on_shard(self, seq_id: int, shard: int):
        """[(page_idx, phys)] of a sequence's resident pages homed on
        ``shard`` — the warm-drain work list."""
        return [(k[1], phys) for k, phys in self._resident.items()
                if k[0] == seq_id and self.shard_of_phys(phys) == shard]

    def disable_shard(self, shard: int):
        """Take a shard's window out of service (node failure): nothing
        can be allocated there again, and its prefix index/cache is
        gone with the window.  The caller is responsible for freeing
        the sequences that lost pages (``sequences_on_shard``)."""
        self._dead_shards.add(shard)
        self._free[shard] = []
        for phys in [p for p in self._page_digest
                     if self.shard_of_phys(p) == shard]:
            self._invalidate(phys)
            self._cached.pop(phys, None)
        self._prefix_index[shard] = {}

    # -- elastic membership (drain / join) -----------------------------------

    def park_shard(self, shard: int):
        """Take a shard out of allocation WITHOUT losing its window (a
        planned drain, not a failure): ``_take_phys`` refuses it and the
        prefix walk skips it, but the free list survives so a later
        ``unpark_shard`` returns the window to service untouched."""
        self._parked_shards.add(shard)

    def unpark_shard(self, shard: int):
        """Return a parked shard's window to allocation (node re-join)."""
        if shard in self._dead_shards:
            raise RuntimeError(
                f"page shard {shard} is dead (node failed); a lost window "
                "cannot rejoin — its contents are gone")
        self._parked_shards.discard(shard)

    def migrate_page(self, src_phys: int, dst_shard: int) -> int:
        """Warm-path live migration of ONE physical page onto
        ``dst_shard`` via a device-side copy (``PageStore.copy_page`` —
        the bytes never cross the host boundary).  Every logical sharer
        follows the page: resident mappings remap in place (LRU order
        preserved), the refcount transfers whole, and a prefix-index
        entry re-homes under the destination shard so warm admissions
        keep hitting it.  The source slot returns to its shard's free
        list.  Returns the new physical id."""
        src_shard = self.shard_of_phys(src_phys)
        if src_shard == dst_shard:
            return src_phys
        if src_phys not in self._rc and src_phys not in self._cached:
            raise ValueError(f"page {src_phys} is not resident")
        new = self._take_phys(dst_shard)
        self.store.copy_page(src_phys, new)
        for lkey, phys in self._resident.items():            # LRU preserved
            if phys == src_phys:
                self._resident[lkey] = new
        if src_phys in self._rc:
            self._rc[new] = self._rc.pop(src_phys)
        d = self._page_digest.pop(src_phys, None)
        if d is not None:
            self._prefix_index[src_shard].pop(d, None)
            self._prefix_index[dst_shard][d] = new
            self._page_digest[new] = d
        if src_phys in self._cached:
            self._cached.pop(src_phys)
            self._cached[new] = None
        self._free[src_shard].append(src_phys)
        self._bump(src_shard, "migrated_out")
        self._bump(dst_shard, "migrated_in")
        return new

    def release_shard_cache(self, shard: int):
        """Drop the unreferenced prefix-cache pages a draining shard
        still holds: they are reclaimable by definition (no sequence
        references them), so a drain spends migration bandwidth only on
        live pages and lets warm prompts recompute later."""
        for phys in [p for p in self._cached
                     if self.shard_of_phys(p) == shard]:
            self._cached.pop(phys)
            self._invalidate(phys)
            self._free[shard].append(phys)

    # -- page lifecycle ------------------------------------------------------

    def _map(self, lkey, phys: int):
        """Bind a logical page to a physical one (refcounted; a cached
        page being re-referenced leaves the reclaim list)."""
        self._resident[lkey] = phys
        self._rc[phys] = self._rc.get(phys, 0) + 1
        self._cached.pop(phys, None)

    def _unmap(self, lkey):
        """Release one logical page.  The physical slot is returned when
        the last sharer leaves — to the prefix cache if the page is
        registered (still warm for identical prompts), else to the
        shard's free list."""
        phys = self._resident.pop(lkey)
        self._pinned.discard(lkey)
        self._prefetched.discard(lkey)
        rc = self._rc[phys] - 1
        if rc > 0:
            self._rc[phys] = rc
            return
        del self._rc[phys]
        if phys in self._page_digest:
            self._cached[phys] = None
        else:
            self._free[self.shard_of_phys(phys)].append(phys)

    def _invalidate(self, phys: int):
        """Drop a page's prefix-index entry (the page is leaving HBM or
        being reclaimed; the index only ever points at window pages)."""
        d = self._page_digest.pop(phys, None)
        if d is not None:
            self._prefix_index[self.shard_of_phys(phys)].pop(d, None)

    def _evict_one(self, shard: int):
        # LRU among the shard's unpinned, UNSHARED pages (pinned =
        # in-flight step; shared = prefix pages other sequences still
        # read — eviction refuses those until every sharer releases);
        # tiering never crosses a node boundary — each DockerSSD spills
        # to its own flash
        victim = None
        for lkey, phys in self._resident.items():            # LRU order
            if lkey not in self._pinned and self._rc[phys] == 1 and \
                    self.shard_of_phys(phys) == shard:
                victim = lkey
                break
        if victim is None:
            raise RuntimeError(
                "HBM window too small for the pinned working set "
                f"(shard {shard}: {len(self._pinned)} pages pinned, "
                "shared prefix pages are not evictable, "
                f"{self.pages_per_shard} per shard)")
        phys = self._resident.pop(victim)
        self._pinned.discard(victim)
        del self._rc[phys]
        self._invalidate(phys)
        self._host[victim] = self.store.read_page(phys)
        self._free[shard].append(phys)
        self._bump(shard, "page_outs")
        self._bump(shard, "bytes_out", self.store.page_bytes())

    def _take_phys(self, shard: int) -> int:
        """Claim one physical slot on ``shard``: free list first, then
        reclaim the LRU unreferenced cache page, then evict."""
        if shard in self._dead_shards:
            raise RuntimeError(f"page shard {shard} is dead (node failed)")
        if shard in self._parked_shards:
            raise RuntimeError(
                f"page shard {shard} is parked (node drained); "
                "unpark_shard re-joins it")
        if self._free[shard]:
            return self._free[shard].pop()
        for phys in self._cached:                            # LRU order
            if self.shard_of_phys(phys) == shard:
                self._cached.pop(phys)
                self._invalidate(phys)
                return phys
        self._evict_one(shard)
        return self._free[shard].pop()

    def _alloc(self, lkey) -> int:
        phys = self._take_phys(self.shard_of(lkey[0], lkey[1]))
        self._map(lkey, phys)
        return phys

    def _page_in(self, lkey) -> int:
        """Bring a host-tier page into HBM."""
        phys = self._alloc(lkey)
        self.store.write_page(phys, *self._host.pop(lkey))
        shard = self.shard_of_phys(phys)
        self._bump(shard, "page_ins")
        self._bump(shard, "bytes_in", self.store.page_bytes())
        return phys

    # -- prefix page cache (content-addressed sharing + CoW) -----------------

    def _hasher(self):
        """Fresh format-keyed hasher: the page format (dtype + layout
        version) participates in every content address, so fp32 and
        int8 pages of identical tokens never share a digest."""
        return hashlib.blake2b(digest_size=16, key=self._format_key)

    def _digest(self, toks: np.ndarray) -> bytes:
        """Content address of a token prefix: one digest identifies the
        KV of every position it covers (params/config are fixed per
        server, so token identity implies KV identity; the format key
        scopes it to this store's page layout)."""
        h = self._hasher()
        h.update(toks.tobytes())
        return h.digest()

    @staticmethod
    def _probe_page(idx: Dict[bytes, int], toks: np.ndarray,
                    lo: int, hi: int, hasher):
        """Longest indexed prefix of ``toks`` ending inside (lo, hi].
        ``hasher`` already covers ``toks[:lo]`` — each candidate end
        forks it and hashes only the page's own tokens, so a whole
        prefix walk costs O(len * page) bytes, not O(len^2)."""
        for end in range(hi, lo, -1):
            hh = hasher.copy()
            hh.update(toks[lo:end].tobytes())
            phys = idx.get(hh.digest())
            if phys is not None:
                return end, phys
        return None

    def _walk_prefix(self, toks: np.ndarray, shard_for, on_hit=None) -> int:
        """Walk the prefix chain page by page.  The returned coverage is
        capped at len-1 — admission always computes at least the final
        token's logits — but the *probe* runs to the full prompt length,
        so an identical prompt shares its tail page too (the recomputed
        final token CoWs into a copy).  A partial-page hit ends the
        chain (positions after it belong to this sequence alone)."""
        cap = int(toks.shape[0]) - 1
        n, pi = 0, 0
        hasher = self._hasher()                    # covers toks[:n]
        while n < cap:
            shard = shard_for(pi)
            if shard in self._dead_shards or shard in self._parked_shards:
                break
            got = self._probe_page(self._prefix_index[shard], toks,
                                   n, min(n + self.page,
                                          int(toks.shape[0])), hasher)
            if got is None:
                break
            end, phys = got
            if on_hit is not None:
                on_hit(pi, shard, min(end, cap) - n, phys)
            hasher.update(toks[n:end].tobytes())
            n = end
            pi += 1
            if end % self.page or end >= cap:
                break
        return min(n, cap)

    def match_prefix(self, seq_id: int, tokens) -> int:
        """Map the longest indexed prefix of a prompt into ``seq_id``'s
        page table: each hit is a refcount++ on an already-resident page
        — zero prefill compute for the covered tokens.  Sets the
        sequence length to the covered count and returns it."""
        toks = np.asarray(tokens, np.int32)

        def on_hit(pi, shard, n_toks, phys):
            self._map((seq_id, pi), phys)
            self._bump(shard, "prefix_hits")
            self._bump(shard, "prefix_tokens", n_toks)

        n = self._walk_prefix(toks, lambda pi: self.shard_of(seq_id, pi),
                              on_hit)
        self._lengths[seq_id] = n
        return n

    def probe_prefix(self, seq_id: int, tokens) -> int:
        """How many tokens :meth:`match_prefix` would cover right now,
        without mapping anything (admission telemetry / routing)."""
        return self._walk_prefix(np.asarray(tokens, np.int32),
                                 lambda pi: self.shard_of(seq_id, pi))

    def prefix_tokens_on_shard(self, tokens, shard: int) -> int:
        """Tokens of ``tokens`` shard ``shard``'s index could serve if
        the sequence were placed entirely there — the routing signal
        for placement policies (admit where the prefix already lives)."""
        return self._walk_prefix(np.asarray(tokens, np.int32),
                                 lambda pi: shard)

    def register_prefix(self, seq_id: int, tokens):
        """Index the prompt pages a finished prefill wrote, full pages
        under their chain digest plus the partial tail (later decode
        appends land at offsets past the digest's coverage, so entries
        stay valid until the page leaves HBM)."""
        toks = np.asarray(tokens, np.int32)
        s = int(toks.shape[0])
        for pi in range(self.pages_needed(s)):
            phys = self._resident.get((seq_id, pi))
            if phys is None or phys in self._page_digest:
                continue                  # spilled, or already indexed
            d = self._digest(toks[:min((pi + 1) * self.page, s)])
            shard = self.shard_of_phys(phys)
            if d in self._prefix_index[shard]:
                continue                  # identical content indexed
            self._prefix_index[shard][d] = phys
            self._page_digest[phys] = d

    def clear_prefix_cache(self):
        """Forget every registered prefix: index entries dropped,
        unreferenced cache pages returned to their free lists.  Mapped
        pages stay with their sharers — they just stop being
        discoverable (bench/test isolation knob)."""
        for phys in list(self._page_digest):
            self._invalidate(phys)
        for phys in list(self._cached):
            self._cached.pop(phys)
            self._free[self.shard_of_phys(phys)].append(phys)

    def make_writable(self, seq_id: int, page_idx: int) -> int:
        """Copy-on-write split: before any append lands in a shared
        page, this sharer gets a private device-side copy (the shared
        original keeps its index entry and remaining sharers).  No-op
        on exclusively-held pages.  Returns the writable physical id."""
        lkey = (seq_id, page_idx)
        phys = self._resident[lkey]
        if self._rc[phys] == 1:
            return phys
        shard = self.shard_of(seq_id, page_idx)
        new = self._take_phys(shard)
        self.store.copy_page(phys, new)
        self._rc[phys] -= 1
        self._rc[new] = 1
        self._resident[lkey] = new
        self._bump(shard, "cow_splits")
        return new

    def _writable_tail(self, seq_id: int):
        """Appends land mid-page when the committed length is not
        page-aligned — CoW that tail page if it is shared."""
        n = self._lengths[seq_id]
        if n % self.page:
            self.make_writable(seq_id, n // self.page)

    def row(self, seq_id: int, n_pages: int) -> List[int]:
        """The sequence's current physical page row (CoW-fresh), in
        logical order — what a jitted step's page table must carry
        after any make_writable splits remapped pages."""
        return [self._resident[(seq_id, pi)] for pi in range(n_pages)]

    def ensure_page(self, seq_id: int, page_idx: int, *, pin: bool = False,
                    count: bool = True) -> int:
        """Make one logical page resident; returns its physical id.
        ``count=False`` skips the hit/miss accounting (write-path touches
        — the facade's per-token appends — are not cache lookups; only
        view assembly and explicit residency checks are)."""
        lkey = (seq_id, page_idx)
        if lkey in self._resident:
            self._resident.move_to_end(lkey)
            if count:
                shard = self.shard_of_phys(self._resident[lkey])
                if lkey in self._prefetched:
                    self._bump(shard, "prefetch_hits")
                    self._prefetched.discard(lkey)
                self._bump(shard, "hits")
        elif lkey in self._host:
            if count:
                self._bump(self.shard_of(seq_id, page_idx), "misses")
            self._page_in(lkey)
        else:  # brand-new page
            self._alloc(lkey)
        if pin:
            self._pinned.add(lkey)
        return self._resident[lkey]

    def ensure_resident(self, seq_id: int, *, pin: bool = False,
                        n_tokens: Optional[int] = None) -> List[int]:
        """Make every page covering ``n_tokens`` (default: the current
        length) resident; returns physical ids in logical order.  With
        ``pin=True`` the pages are protected from eviction until
        :meth:`unpin_all` (used while assembling a batched step so later
        page-ins cannot invalidate earlier entries)."""
        if n_tokens is None:
            n_tokens = self._lengths[seq_id]
        return [self.ensure_page(seq_id, pi, pin=pin)
                for pi in range(self.pages_needed(n_tokens))]

    def prepare_append(self, seq_id: int) -> List[int]:
        """Pin + return the page-table row for appending one token: every
        page covering positions [0, length] resident, in logical order,
        the tail page CoW-split if shared (the append writes into it).
        Commit the append with :meth:`commit_append` after the step."""
        rows = self.ensure_resident(seq_id, pin=True,
                                    n_tokens=self._lengths[seq_id] + 1)
        self._writable_tail(seq_id)
        return self.row(seq_id, len(rows))

    def commit_append(self, seq_id: int, n: int = 1):
        self._lengths[seq_id] += n

    # -- horizon reservation (fused multi-token decode) ----------------------

    def reserve_horizon(self, seq_id: int, horizon: int) -> List[int]:
        """Pin + return the page-table row for appending up to ``horizon``
        tokens on device: every page covering positions
        [0, length + horizon) resident and pinned, in logical order.

        The fused decode loop advances page slots *on device* against
        this reservation — the host is not consulted between the
        horizon's steps.  Reserved-but-unused pages (a sequence that hit
        EOS or its budget mid-horizon) are rolled back by
        :meth:`commit_horizon`; they hold no data, so the rollback is a
        pure free-list return."""
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        rows = self.ensure_resident(seq_id, pin=True,
                                    n_tokens=self._lengths[seq_id] + horizon)
        # the horizon's first append may land mid-page in a shared
        # prefix page: split it now, on the host, before the device loop
        self._writable_tail(seq_id)
        return self.row(seq_id, len(rows))

    def commit_horizon(self, seq_id: int, n_committed: int) -> int:
        """Commit ``n_committed`` appended tokens and roll back the rest
        of the horizon reservation: reserved pages wholly past the new
        length return to their shard's free list.  Returns the number of
        pages rolled back."""
        self._lengths[seq_id] += n_committed
        used = self.pages_needed(self._lengths[seq_id])
        rolled = 0
        for lkey in [k for k in self._resident
                     if k[0] == seq_id and k[1] >= used]:
            shard = self.shard_of(lkey[0], lkey[1])
            self._unmap(lkey)
            self._bump(shard, "horizon_pages_rolled_back")
            rolled += 1
        return rolled

    def unpin_all(self):
        self._pinned.clear()

    def prefetch(self, seq_id: int):
        """Async prefetch model: pages needed by the *next* step are pulled
        in now so the transfer overlaps compute (double buffering)."""
        n_pages = self.pages_needed(self._lengths[seq_id] + 1)
        for pi in range(n_pages):
            lkey = (seq_id, pi)
            if lkey in self._host:
                self._page_in(lkey)
                self._prefetched.add(lkey)
