"""Pool serving: the distributed decode path over DockerSSD nodes, on one
card.

``PoolServer`` turns the single-device :class:`~repro_torch.runtime.
serve.PagedServer` into one system spanning the storage pool (the
paper's preferred offloading mode, Fig 8b).  The port of
``repro.runtime.pool``: there, each node of the pool is one device of a
mesh and its HBM window is that device's shard of the PageStore; here N
nodes are emulated on one card, and node ``s``'s window is the slice
``[s * P, (s + 1) * P)`` of one PageStore's pages (P =
``hbm_pages_per_node``).  One device step per token serves every
sequence in the pool, wherever its pages live.

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
page's slot of the one store, each node runs paged attention over the
pages of *its own* window only (the pool form of the paged-attention
kernels), and the nodes' online-softmax partials ``(acc, m, l)`` are
merged exactly by max-rebase in one launch.  The reference's
``shard_map`` bodies (decode, horizon, speculative verify, prefill
chunk) all reach attention through one hook, so here they reduce to one
override of ``PagedServer._kernel_attention``; its appends stay one
write at the global physical id (the reference drops every non-owner's
write, and one store has one slot).  Control traffic (admission /
placement / free) rides Ether-oN frames.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.core.kv_tier import PageStore, PageTableManager
from repro_torch.kernels import ops
from repro_torch.runtime.serve import PagedServer


def mesh_bucket(n: int) -> int:
    """Pow2 capacity bucket for an elastic pool of ``n`` nodes (the
    reference's ``runtime.sharding.mesh_bucket``): membership changes
    inside the bucket keep every node's window; growing past it means
    provisioning a new server."""
    if n < 1:
        raise ValueError(f"pool capacity must be >= 1, got {n}")
    return 1 << (n - 1).bit_length()


def _visible_devices(device) -> int:
    """The reference's default pool size, its visible devices: the cards
    torch sees for a CUDA server, one for a CPU one."""
    dev = torch.device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


class PoolServer(PagedServer):
    """Tiered-KV serving across the storage pool, the nodes emulated on
    one card.

    Same public surface as :class:`PagedServer` (the router and the
    StoragePool frontend talk to it identically) plus the pool surface:
    per-node capacity (``node_free_pages``), placement
    (``least_loaded_node``, ``add_request(..., node=)``), failure
    (``fail_node``), elastic membership (``activate_node``,
    ``drain_node``) and per-node telemetry (``node_tier_stats``).

    The page-table manager allocates per shard (each node tiers against
    its own window and flash), and attention runs the pool form of the
    paged-attention kernels over the N windows.
    """

    def __init__(self, model, params, *, n_nodes: Optional[int] = None,
                 active: Optional[int] = None, page_size: int = 16,
                 hbm_pages_per_node: int = 32, policy: str = "placed",
                 page_dtype: str = "fp32",
                 hbm_bytes_per_node: Optional[int] = None, device="cuda"):
        if policy not in ("placed", "striped"):
            raise ValueError(f"unknown placement policy {policy!r}")
        if active is not None and policy != "placed":
            raise ValueError(
                "elastic pools (active=) need the placed policy — a "
                "striped extent spans every node by construction, so "
                "membership cannot change under it")
        n = n_nodes if n_nodes else _visible_devices(device)
        if active is not None:
            # elastic capacity is sized for the pow2 bucket: membership
            # changes inside the bucket keep every window, growing past
            # it means provisioning a new server
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
                dtype=model.compute_dtype, page_dtype=page_dtype)
            hbm_pages_per_node = max(1, int(hbm_bytes_per_node) // pb)
        self.pages_per_node = hbm_pages_per_node
        self.policy = policy
        self._placement: Dict[int, int] = {}
        self._dead: set = set()
        super().__init__(model, params, page_size=page_size,
                         hbm_pages=self.n_nodes * hbm_pages_per_node,
                         page_dtype=page_dtype, device=device)

    # -- table factory -------------------------------------------------------

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

    def begin_request(self, seq_id: int, prompt, *,
                      node: Optional[int] = None) -> int:
        """Open an admission onto the pool.  ``node`` pins the placement
        (the StoragePool frontend routes it there); default prefers the
        node already holding the prompt's prefix, else least-loaded.
        Striped policy ignores ``node``."""
        if self.policy == "placed" and seq_id not in self._placement:
            if node is None:
                node = self.pick_prefix_node(prompt)
            target = self.least_loaded_node() if node is None else int(node)
            if target in self._dead:
                raise RuntimeError(f"node {target} is dead")
            self._placement[seq_id] = target
        try:
            return super().begin_request(seq_id, prompt)
        except Exception:
            self._placement.pop(seq_id, None)
            raise

    def add_request(self, seq_id: int, prompt, *,
                    node: Optional[int] = None,
                    chunk: Optional[int] = None):
        """Blocking admission: placement + cached-prefix match + chunked
        prefill of the uncached suffix (see PagedServer.add_request)."""
        self.begin_request(seq_id, prompt, node=node)
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
        kernels (f32, or fused-dequant over int8/fp8 codes), decode form
        for a batch table, chunk form for a prefill chunk's expanded
        row."""
        st = self.store.layer_state(li)
        q = q.to(self.dtype).contiguous()
        if self.quantized:
            return ops.paged_attention_pool_q8(
                q, st["k"], st["v"], st["ks"], st["vs"], page_table, lengths,
                n_nodes=self.n_nodes, n_local=self.pages_per_node)
        return ops.paged_attention_pool(
            q, st["k"], st["v"], page_table, lengths, n_nodes=self.n_nodes,
            n_local=self.pages_per_node)

    def step_reference(self, tokens):
        raise NotImplementedError(
            "the pool path is validated against a 1-node PagedServer "
            "running the same workload (tests/test_torch_pool.py)")
