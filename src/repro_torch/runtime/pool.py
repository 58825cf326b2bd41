"""Pool serving: the distributed decode path over DockerSSD nodes.

``PoolServer`` turns the single-device :class:`~repro_torch.runtime.
serve.PagedServer` into one system spanning the storage pool (the
paper's preferred offloading mode, Fig 8b).  The port of
``repro.runtime.pool``, where each node of the pool is one device of a
mesh and its HBM window is that device's shard of the PageStore.  Two
routes, one host program:

  * **one card** (no ``mesh``): N nodes emulated in one process; node
    ``s``'s window is the slice ``[s * P, (s + 1) * P)`` of one
    PageStore's pages (P = ``hbm_pages_per_node``), and the pool form of
    the paged-attention kernels merges the nodes' partials in one launch;
  * **one node a rank** (``mesh=``, a ``DeviceMesh`` with a ``model``
    dim; ``runtime.sharding.pool_mesh``): rank r of the ``model`` group
    is node r and holds only its window, a :class:`NodeWindowStore` of P
    pages (the reference's ``pool_store_spec``).  Every rank runs the
    same host program (page table, placement, router, autoscaler) over
    the global page ids, node r owning ``[r * P, (r + 1) * P)``; K/V
    appends land only in the pages a rank owns; attention runs the pool
    form over the rank's own window, unmerged, folds its splits, and
    merges across ranks with ``combine_partials(..., group=)``: one
    ``all_reduce`` MAX and one SUM, the reference's ``pmax`` and two
    ``psum``s.  Pages that cross nodes (a drain's migration, a page-in
    or copy-on-write onto another node) move by ``broadcast`` from the
    owner.  Tokens agree across ranks because every rank receives the
    same merged attention; :meth:`PoolServer.sync_check` all-reduces a
    digest of the tables, the tokens and the logits and raises on a
    mismatch.

Placement policies (``PageTableManager.shard_of``):

  * ``"placed"``: each sequence's extent lives wholly on one node,
    chosen least-loaded by the pool frontend (StoragePool routes the
    admission over Ether-oN control frames).  Node failure only costs
    that node's sequences; the router re-prefills them elsewhere.
  * ``"striped"``: a sequence's logical pages stripe round-robin across
    all nodes (the D-Cache sequence-sharded extent).  A node failure
    costs the pool.

Both run through the same device step, because attention is
ownership-driven: every node computes q/k/v for the new tokens (each
DockerSSD stores the full model in its flash), the new K/V lands in its
page's slot, each node runs paged attention over the pages of *its own*
window only, and the nodes' online-softmax partials ``(acc, m, l)`` are
merged exactly by max-rebase.  The reference's ``shard_map`` bodies
(decode, horizon, speculative verify, prefill chunk) all reach
attention through one hook, so here they reduce to one override of
``PagedServer._kernel_attention``, plus the window store's append.
Control traffic (admission / placement / free) rides Ether-oN frames.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import torch

from repro_torch.core.kv_tier import PageStore, PageTableManager
from repro_torch.kernels import ops
from repro_torch.runtime.serve import (PagedServer, combine_partials,
                                       kernel_query)
from repro_torch.runtime.sharding import POOL_AXIS
from repro_torch.runtime.sharding import mesh_bucket  # noqa: F401


#: host steps between two :meth:`PoolServer.sync_check`s on ranks
SYNC_CHECK_EVERY = 16


def _visible_devices(device, mesh=None) -> int:
    """The reference's default pool size: the mesh's ``model`` ranks when
    a mesh is given, else its visible devices (the cards torch sees for a
    CUDA server, one for a CPU one)."""
    if mesh is not None:
        return int(mesh.size(mesh.mesh_dim_names.index(POOL_AXIS)))
    dev = torch.device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def window_rows(rows: torch.Tensor, node: int, n_local: int) -> torch.Tensor:
    """Global page ids -> node ``node``'s window ids: an id in ``[node *
    n_local, (node + 1) * n_local)`` becomes its offset there, any other
    id ``n_local``.  The one rule of the rank route: ``n_local`` is the
    window store's sentinel (an append there is dropped), and the id the
    one-node pool form's ownership test (``phys // n_local == 0``, in the
    kernel, its wrapper and ``ref.pool_split_owned``) rejects."""
    loc = rows - node * n_local
    return torch.where((loc >= 0) & (loc < n_local), loc,
                       torch.full_like(loc, n_local))


def _new_stats() -> Dict[str, int]:
    return {"all_reduce": 0, "all_reduce_bytes": 0, "broadcast": 0,
            "broadcast_bytes": 0}


class NodeWindowStore:
    """One rank's share of a pool's PageStore: the window of node ``node``
    (``n_local`` stacked pages, a :class:`PageStore` of its own) behind
    the global page ids ``[0, n_nodes * n_local)`` the host program
    uses, so the ``PageTableManager`` runs unchanged on every rank.

    * :meth:`append` and :meth:`layer_state` act on the window: a row
      whose target lies outside it (another node's page, or the
      sentinel) goes to the local sentinel, as the reference's
      ``append_target`` drops non-owned writes.
    * :meth:`read_page` / :meth:`write_page` (the flash tier) and
      :meth:`copy_page` (copy-on-write, a drain's migration) are called
      on every rank in the same order; the rank that owns the source
      holds the bytes, and a page that moves between nodes goes by
      ``broadcast`` from the source rank, written only by the
      destination's.
    """

    def __init__(self, *, node: int, n_nodes: int, n_local: int, group,
                 stats: Dict[str, int], **store_kw):
        self.node, self.n_nodes, self.n_local = node, n_nodes, n_local
        self.group = group
        self.stats = stats
        self.local = PageStore(hbm_pages=n_local, **store_kw)
        self.base = node * n_local
        self.hbm_pages = n_nodes * n_local
        for name in ("page", "device", "dtype", "page_dtype", "quantized",
                     "qmax"):
            setattr(self, name, getattr(self.local, name))

    @property
    def format_key(self) -> str:
        return self.local.format_key

    def page_bytes(self) -> int:
        return self.local.page_bytes()

    def node_of(self, phys: int) -> int:
        return int(phys) // self.n_local

    def _local_id(self, phys: int) -> int:
        return int(phys) - self.base

    def local_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Global page ids -> this window's ids (:func:`window_rows`)."""
        return window_rows(rows, self.node, self.n_local)

    def append(self, li: int, rows, offs, k_new, v_new):
        self.local.append(li, self.local_rows(rows), offs, k_new, v_new)

    def layer_state(self, li: int) -> Dict[str, torch.Tensor]:
        return self.local.layer_state(li)

    def _page(self, phys: int):
        """This rank's stacked page ``phys`` (it must own it): one view a
        buffer, all layers."""
        return [b[:, self._local_id(phys)] for b in self.local._bufs.values()]

    def _move(self, src_node: int, data, dst_phys: int):
        """Bring the stacked page ``data`` (held by ``src_node``'s rank;
        None elsewhere) to ``dst_phys``'s node: a write there when it is
        the same node, else a ``broadcast`` from the source rank, which
        every rank joins and only the destination's writes."""
        import torch.distributed as dist

        dst_node = self.node_of(dst_phys)
        if src_node == dst_node:
            if self.node == dst_node:
                for buf, t in zip(self._page(dst_phys), data):
                    buf.copy_(t)
            return
        src_rank = dist.get_global_rank(self.group, src_node)
        for i, buf in enumerate(self.local._bufs.values()):
            # the page's bytes, whatever its dtype (fp8 codes included)
            t = (data[i].to(self.device).contiguous().view(torch.uint8)
                 if self.node == src_node else
                 torch.empty(buf.shape[:1] + buf.shape[2:], dtype=buf.dtype,
                             device=self.device).view(torch.uint8))
            dist.broadcast(t, src=src_rank, group=self.group)
            self.stats["broadcast"] += 1
            self.stats["broadcast_bytes"] += t.numel()
            if self.node == dst_node:
                buf[:, self._local_id(dst_phys)].copy_(t.view(buf.dtype))

    def read_page(self, phys: int):
        """Device -> host (a page-out): ``(owner node, the page's tensors
        on the CPU)`` on the owner's rank, ``(owner node, None)`` on the
        others.  Opaque: pass it back to :meth:`write_page`."""
        node = self.node_of(phys)
        if node != self.node:
            return node, None
        return node, tuple(t.to("cpu", copy=True) for t in self._page(phys))

    def write_page(self, phys: int, src_node: int, data):
        """Host -> device (a page-in) at ``phys``, from the host copy of
        ``src_node``'s rank."""
        self._move(src_node, data, phys)

    def copy_page(self, src: int, dst: int):
        """Stacked-page copy (copy-on-write, migration): local when both
        pages are on one node, else a broadcast from the source rank."""
        node = self.node_of(src)
        self._move(node, self._page(src) if node == self.node else None, dst)


class PoolServer(PagedServer):
    """Tiered-KV serving across the storage pool: the nodes emulated on
    one card, or, with ``mesh``, one node a rank of the mesh's ``model``
    group (see the module docstring).

    Same public surface as :class:`PagedServer` (the router and the
    StoragePool frontend talk to it identically) plus the pool surface:
    per-node capacity (``node_free_pages``), placement
    (``least_loaded_node``, ``add_request(..., node=)``), failure
    (``fail_node``), elastic membership (``activate_node``,
    ``drain_node``) and per-node telemetry (``node_tier_stats``).

    The page-table manager allocates per shard (each node tiers against
    its own window and flash), and attention runs the pool form of the
    paged-attention kernels over the N windows, merged in the launch on
    one card and by ``all_reduce`` across ranks.  On ranks, every
    ``SYNC_CHECK_EVERY`` host steps and at the end of :meth:`decode` the
    ranks compare digests (:meth:`sync_check`), and
    ``collective_stats`` counts the collectives and their bytes.
    """

    def __init__(self, model, params, *, n_nodes: Optional[int] = None,
                 active: Optional[int] = None, mesh=None,
                 page_size: int = 16,
                 hbm_pages_per_node: int = 32, dtype=torch.float32,
                 policy: str = "placed", prefix_cache: bool = True,
                 page_dtype: str = "fp32",
                 hbm_bytes_per_node: Optional[int] = None, device="cuda"):
        if policy not in ("placed", "striped"):
            raise ValueError(f"unknown placement policy {policy!r}")
        if active is not None and policy != "placed":
            raise ValueError(
                "elastic pools (active=) need the placed policy — a "
                "striped extent spans every node by construction, so "
                "membership cannot change under it")
        self.mesh, self.group, self.node = mesh, None, None
        self.collective_stats = _new_stats()
        self._digest = hashlib.blake2b(digest_size=16)
        self._host_steps = 0
        self._last_logits = None
        self._lt_src = self._lt = None
        if mesh is not None:
            if POOL_AXIS not in (mesh.mesh_dim_names or ()):
                raise ValueError(f"pool mesh needs a {POOL_AXIS!r} axis")
            # the mesh is the pool: one node a rank of its model group
            n = _visible_devices(device, mesh)
            if n_nodes is not None and n_nodes != n:
                raise ValueError(f"n_nodes={n_nodes} over a pool mesh of "
                                 f"{n} ranks: the pool serves one node a "
                                 f"rank")
            if active is not None and mesh_bucket(n) != n:
                raise ValueError(f"an elastic pool (active=) needs a pool "
                                 f"mesh of its pow2 bucket, got {n} ranks "
                                 f"(bucket {mesh_bucket(n)})")
            self.group = mesh.get_group(POOL_AXIS)
            self.node = int(mesh.get_local_rank(POOL_AXIS))
        else:
            n = n_nodes if n_nodes else _visible_devices(device)
            if active is not None:
                # elastic capacity is sized for the pow2 bucket:
                # membership changes inside the bucket keep every
                # window, growing past it means provisioning a new
                # server
                n = mesh_bucket(n)
        self.n_nodes = int(n)
        if active is not None and not (1 <= active <= self.n_nodes):
            raise ValueError(f"active={active} must be in "
                             f"[1, {self.n_nodes}]")
        # elastic membership: shards beyond the initially-active count
        # start parked — their windows exist (the store is sized for the
        # full bucket) but placement skips them until a join activates
        # them
        self._parked: set = (set(range(active, self.n_nodes))
                             if active is not None else set())
        if hbm_bytes_per_node is not None:
            # per-node byte budget -> dtype-aware page count (the same
            # capacity knob as a byte budget, per DockerSSD)
            pb = PageStore.stacked_page_bytes(
                n_layers=model.cfg.n_layers, page_size=page_size,
                n_kv_heads=model.cfg.n_kv_heads, head_dim=model.cfg.hd,
                dtype=dtype, page_dtype=page_dtype)
            hbm_pages_per_node = max(1, int(hbm_bytes_per_node) // pb)
        self.pages_per_node = hbm_pages_per_node
        self.policy = policy
        self._placement: Dict[int, int] = {}
        self._dead: set = set()
        super().__init__(model, params, page_size=page_size,
                         hbm_pages=self.n_nodes * hbm_pages_per_node,
                         dtype=dtype, prefix_cache=prefix_cache,
                         page_dtype=page_dtype, device=device)

    # -- store / table factories ---------------------------------------------

    def _new_store(self):
        if self.group is None:
            return super()._new_store()
        return NodeWindowStore(
            node=self.node, n_nodes=self.n_nodes,
            n_local=self.pages_per_node, group=self.group,
            stats=self.collective_stats, n_layers=self.cfg.n_layers,
            page_size=self.page, n_kv_heads=self.cfg.n_kv_heads,
            head_dim=self.cfg.hd, dtype=self.dtype,
            page_dtype=self.page_dtype, device=self.device)

    def _new_table(self) -> PageTableManager:
        table = PageTableManager(self.store, n_shards=self.n_nodes,
                                 shard_of=self._shard_of)
        for s in self._dead:
            table.disable_shard(s)
        for s in self._parked:
            table.park_shard(s)
        return table

    def _shard_of(self, seq_id: int, page_idx: int) -> int:
        if self.policy == "placed":
            return self._placement[seq_id]
        return page_idx % self.n_nodes

    # -- pool placement surface ----------------------------------------------

    def alive_nodes(self) -> List[int]:
        """Nodes placement may target: not failed, not parked."""
        return [s for s in range(self.n_nodes)
                if s not in self._dead and s not in self._parked]

    def parked_nodes(self) -> List[int]:
        return sorted(self._parked)

    @property
    def active_count(self) -> int:
        return len(self.alive_nodes())

    def node_free_pages(self) -> List[int]:
        return [self.table.shard_free_pages(s) for s in range(self.n_nodes)]

    def least_loaded_node(self) -> int:
        alive = self.alive_nodes()
        if not alive:
            raise RuntimeError("no alive pool nodes")
        return max(alive, key=lambda s: (self.table.shard_free_pages(s), -s))

    def best_prefix_node(self, prompt):
        """(node, tokens): the alive node whose per-shard prefix index
        covers the longest prefix of ``prompt`` — the placement signal
        that routes a request to where its prefix KV already lives.
        (None, 0) when nothing matches."""
        best, best_n = None, 0
        for s in self.alive_nodes():
            n = self.table.prefix_tokens_on_shard(prompt, s)
            if n > best_n:
                best, best_n = s, n
        return best, best_n

    def pick_prefix_node(self, prompt, n_tokens: Optional[int] = None):
        """The prefix-placement policy (the StoragePool frontend and
        direct ``begin_request`` both route through it): the
        prefix-owning node wins only while its window has room for the
        request's whole ``n_tokens`` extent (default: the prompt).  None
        -> caller falls back to least-loaded."""
        node, hit = self.best_prefix_node(prompt)
        if not hit:
            return None
        need = self.pages_needed(n_tokens if n_tokens is not None
                                 else len(prompt))
        if self.table.shard_free_pages(node) < need:
            return None
        return node

    def _open_request(self, seq_id: int, prompt, *,
                      node: Optional[int] = None):
        """Place the sequence, then queue its prompt (see
        :meth:`begin_request`)."""
        if self.policy == "placed" and seq_id not in self._placement:
            if node is None:
                node = self.pick_prefix_node(prompt)
            target = self.least_loaded_node() if node is None else int(node)
            if target in self._dead:
                raise RuntimeError(f"node {target} is dead")
            self._placement[seq_id] = target
        try:
            return super()._open_request(seq_id, prompt)
        except Exception:
            self._placement.pop(seq_id, None)
            raise

    def begin_request(self, seq_id: int, prompt, *,
                      node: Optional[int] = None) -> int:
        """Open an admission onto the pool.  ``node`` pins the placement
        (the StoragePool frontend routes it there); default prefers the
        node already holding the prompt's prefix, else least-loaded.
        Striped policy ignores ``node``.  Returns the prompt tokens the
        cache covers right now."""
        prompt = self._open_request(seq_id, prompt, node=node)
        if not self.prefix_cache:
            return 0
        return self.table.probe_prefix(seq_id, prompt)

    def add_request(self, seq_id: int, prompt, *,
                    node: Optional[int] = None,
                    chunk: Optional[int] = None):
        """Blocking admission: placement + cached-prefix match + chunked
        prefill of the uncached suffix (see PagedServer.add_request)."""
        self._open_request(seq_id, prompt, node=node)
        logits = None
        while logits is None:
            logits = self.prefill_chunk(seq_id, chunk)
        return logits

    def free_sequence(self, seq_id: int) -> int:
        freed = super().free_sequence(seq_id)
        self._placement.pop(seq_id, None)
        return freed

    def node_of(self, seq_id: int) -> Optional[int]:
        return self._placement.get(seq_id)

    def fail_node(self, node: int) -> List[int]:
        """Simulated DockerSSD failure: the node's window and flash tier
        are gone.  Every sequence with pages homed there is dropped (its
        ids are returned so the router can re-prefill them on the
        survivors) and the shard is taken out of allocation."""
        victims = set(self.table.sequences_on_shard(node))
        # an admission opened here whose first chunk hasn't allocated
        # pages yet is homed here too (placement is recorded at
        # begin_request, pages only at the first prefill chunk) — it
        # must requeue with the rest, not prefill onto a dead shard
        victims |= {s for s, n in self._placement.items() if n == node}
        victims = sorted(victims)
        self._dead.add(node)
        self._parked.discard(node)
        for s in victims:
            self.free_sequence(s)
        self.table.disable_shard(node)
        return victims

    # -- elastic membership (join / drain) ------------------------------------

    def activate_node(self, node: int):
        """Join a parked node into the serving set.  Pure host-side
        bookkeeping: the node's window has existed since startup and an
        inactive node owned no pages (its attention partials are the
        identity), so the very next decode step may place pages there."""
        if node in self._dead:
            raise RuntimeError(
                f"node {node} is dead (window lost); a failed node "
                "cannot rejoin the serving set")
        if not (0 <= node < self.n_nodes):
            raise ValueError(f"node {node} outside the pool bucket "
                             f"[0, {self.n_nodes})")
        self._parked.discard(node)
        self.table.unpark_shard(node)

    def _drain_dst(self, need: int, exclude: int) -> Optional[int]:
        """Pick the warm-migration destination: the least-loaded alive
        node (excluding the drainee) whose window has room for ``need``
        pages.  None -> the caller takes the cold path."""
        cand = [s for s in self.alive_nodes() if s != exclude]
        if not cand:
            return None
        best = max(cand, key=lambda s: (self.table.shard_free_pages(s), -s))
        return best if self.table.shard_free_pages(best) >= need else None

    def drain_node(self, node: int, on_migrate=None) -> Dict:
        """Two-path zero-drop drain: remove ``node`` from the serving
        set while every request keeps decoding.

        Warm path (preferred): each victim sequence's resident pages
        move device-to-device onto a surviving node's window
        (``PageTableManager.migrate_page`` — exact bytes, so outputs
        stay token-identical).  ``on_migrate(seq_id, page_idx, src,
        dst)`` fires per moved page — the StoragePool frontend announces
        each one with a MIGRATE frame for cost accounting.

        Cold path (fallback): a victim whose pages don't fit anywhere
        (or whose destination dies mid-migration) is freed and reported
        in ``cold`` — the caller requeues it through the failover
        machinery, which teacher-forces the already-emitted tokens.

        Shared prefix pages migrate once; every sharer's mapping follows
        the copy.  A sharer later re-placed elsewhere keeps reading the
        moved page — attention ownership is by physical id, so only
        *new* appends land on the sharer's own node.  Runs between
        scheduler steps (no pages pinned).
        """
        if self.policy != "placed":
            raise RuntimeError("striped pools cannot drain a node — the "
                               "extent spans every node by construction")
        if node in self._dead:
            raise RuntimeError(f"node {node} is dead; drain is for "
                               "planned removal of a live node")
        if len(self.alive_nodes()) <= 1:
            raise RuntimeError("cannot drain the last active node")
        # park first so concurrent placement and destination picking
        # exclude the drainee
        self._parked.add(node)
        self.table.park_shard(node)
        victims = set(self.table.sequences_on_shard(node))
        victims |= {s for s, n in self._placement.items() if n == node}
        victims = sorted(victims)
        migrated, cold, moved = 0, [], {}
        for seq in victims:
            try:
                res = self.table.resident_on_shard(seq, node)
                dst = self._drain_dst(len(res), node)
                if dst is None:
                    self.free_sequence(seq)
                    cold.append(seq)
                    continue
                for pi, phys in res:
                    self.table.migrate_page(phys, dst)
                    migrated += 1
                    if on_migrate is not None:
                        on_migrate(seq, pi, node, dst)
                self._placement[seq] = dst
                moved[seq] = dst
            except Exception:
                # destination lost mid-migration (its failover already
                # requeued whatever reached it) — cold path for this
                # victim, survivors re-pick a destination
                self.free_sequence(seq)
                cold.append(seq)
        self.table.release_shard_cache(node)
        return {"victims": victims, "migrated_pages": migrated,
                "cold": cold, "moved": moved}

    # -- per-node telemetry ---------------------------------------------------

    def node_tier_stats(self) -> List[Dict[str, int]]:
        """One stats dict per node — the aggregate ``tier_stats`` is the
        field-wise sum of these (each node owns its window and tier)."""
        return [dict(vars(ss)) for ss in self.table.shard_stats]

    # -- device step: the one attention hook ----------------------------------

    def _kernel_attention(self, q, li, page_table, lengths):
        """Every node's ownership-masked attention over layer ``li``,
        merged across the pool: the pool form of the paged-attention
        kernels (f32 / bf16, or fused-dequant over int8/fp8 codes),
        decode form for a batch table, chunk form for a prefill chunk's
        expanded row.  On ranks, see :meth:`_rank_attention`."""
        st = self.store.layer_state(li)
        q = kernel_query(q, self.dtype)
        if self.group is not None:
            return self._rank_attention(q, st, page_table, lengths)
        if self.quantized:
            o = ops.paged_attention_pool_q8(
                q, st["k"], st["v"], st["ks"], st["vs"], page_table, lengths,
                n_nodes=self.n_nodes, n_local=self.pages_per_node)
        else:
            o = ops.paged_attention_pool(
                q, st["k"], st["v"], page_table, lengths,
                n_nodes=self.n_nodes, n_local=self.pages_per_node)
        return o.to(self.dtype)

    def _local_table(self, page_table):
        """The step's table in this rank's window ids (the store's
        ``local_rows``), once a step: every layer gets the same table
        object.  An expanded row (the chunk form's) stays expanded."""
        if page_table is not self._lt_src:
            if page_table.dim() == 2 and page_table.stride(0) == 0:
                row = self.store.local_rows(page_table[0])
                self._lt = row[None].expand(page_table.shape)
            else:
                self._lt = self.store.local_rows(page_table)
            self._lt_src = page_table
        return self._lt

    def _rank_attention(self, q, st, page_table, lengths):
        """This rank's node: the pool form over its own window (one node
        of ``pages_per_node`` pages, the table in window ids), launched
        unmerged, its splits folded by max-rebase, then the exact merge
        across the ranks by ``all_reduce`` (``combine_partials(...,
        group=)``).  A one-rank group has nothing to reduce: its merge is
        the launch's own, the one-card one-node pool's bits."""
        table = self._local_table(page_table)
        ks, vs = st.get("ks"), st.get("vs")
        if self.n_nodes == 1:
            if self.quantized:
                o = ops.paged_attention_pool_q8(
                    q, st["k"], st["v"], ks, vs, table, lengths, n_nodes=1,
                    n_local=self.pages_per_node)
            else:
                o = ops.paged_attention_pool(
                    q, st["k"], st["v"], table, lengths, n_nodes=1,
                    n_local=self.pages_per_node)
            return o.to(self.dtype)
        acc, m, l = ops.pool_partials(q, st["k"], st["v"], table, lengths,
                                      ks, vs, n_nodes=1,
                                      n_local=self.pages_per_node)
        acc, m, l = ops.ref.merge_split_partials(acc[:, :, 0], m[:, :, 0],
                                                 l[:, :, 0])
        cs = self.collective_stats
        cs["all_reduce"] += 2
        cs["all_reduce_bytes"] += 4 * (m.numel() + l.numel() + acc.numel())
        return combine_partials(acc, m, l, group=self.group).to(self.dtype)

    # -- ranks: the host programs agree ---------------------------------------

    def _note(self, *items):
        """Fold host-side results into the running digest; every
        ``SYNC_CHECK_EVERY`` host steps, :meth:`sync_check`."""
        if self.group is None:
            return
        for it in items:
            self._digest.update(repr(it).encode())
        self._host_steps += 1
        if self._host_steps % SYNC_CHECK_EVERY == 0:
            self.sync_check()

    def sync_check(self):
        """On ranks: all-reduce a digest of this rank's page table,
        placements, the tokens so far and the last logits' bytes, and
        raise unless every rank's is the same (the host programs
        diverged, or the collectives did not give every rank the same
        bits).  A no-op on one card."""
        if self.group is None:
            return
        import torch.distributed as dist

        h = self._digest.copy()
        t = self.table
        h.update(repr((list(t._resident.items()), sorted(t._lengths.items()),
                       sorted(self._placement.items()), sorted(self._dead),
                       sorted(self._parked), self._seqs)).encode())
        if self._last_logits is not None:
            h.update(self._last_logits.float().cpu().numpy().tobytes())
        d = int.from_bytes(h.digest()[:7], "little")
        both = torch.tensor([d, -d], dtype=torch.int64, device=self.device)
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.group)
        self.collective_stats["all_reduce"] += 1
        self.collective_stats["all_reduce_bytes"] += 16
        if int(both[0]) != -int(both[1]):
            raise RuntimeError(
                f"pool ranks diverged (node {self.node}): digests differ "
                f"after {self._host_steps} host steps")

    def prefill_chunk(self, seq_id: int, chunk: Optional[int] = None):
        logits = super().prefill_chunk(seq_id, chunk)
        if logits is not None and self.group is not None:
            self._last_logits = logits
            self._note("prefill", seq_id)
        return logits

    def step_batch(self, tokens: Dict[int, int]):
        seqs, logits = super().step_batch(tokens)
        if self.group is not None:
            self._last_logits = logits
            self._note("step", sorted(tokens.items()))
        return seqs, logits

    def horizon_batch(self, tokens, budgets, horizon, eos_id=None,
                      sampling=None, _key=None):
        out = super().horizon_batch(tokens, budgets, horizon, eos_id,
                                    sampling, _key)
        self._note("horizon", sorted(out.items()))
        return out

    def spec_horizon_batch(self, *args, **kwargs):
        out = super().spec_horizon_batch(*args, **kwargs)
        self._note("spec", sorted(out.items()))
        return out

    def decode(self, *args, **kwargs):
        out = super().decode(*args, **kwargs)
        self.sync_check()
        return out

    def step_reference(self, tokens):
        raise NotImplementedError(
            "the pool path is validated against a 1-node PagedServer "
            "running the same workload (tests/test_torch_pool.py)")
