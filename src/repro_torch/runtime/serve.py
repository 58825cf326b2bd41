"""Serving runtime on torch: the dense path (``make_serving_fns``) and
the paged-KV ``PagedServer``, greedy only.

The port of ``repro.runtime.serve.PagedServer``: a host-side
:class:`~repro_torch.core.kv_tier.PageTableManager` (LRU tiering,
pinning, prefetch, the shared-prefix page cache with copy-on-write)
over a device-resident :class:`~repro_torch.core.kv_tier.PageStore`
with stacked per-layer pages, read by the hand-written CUDA
paged-attention kernels (``kernels.ops``).  Host-side page management
runs between device steps; the device steps are eager PyTorch:

  * a decode step appends every active sequence's new K/V (one batched
    in-place scatter per layer) and runs the paged-attention kernel
    over each layer's page slice;
  * prefill is chunked: each chunk writes its positions' pages and
    attends over the paged context with per-position length ``pos + 1``,
    every position seeing the sequence's one page row (an expanded
    view, which the kernels take as their chunk form);
  * the fused decode horizon (``decode(horizon=H)``) runs H such steps
    with the argmax kept on the device, against pages reserved for the
    whole horizon, and moves one [H, B] tensor of emitted tokens to the
    host per horizon.  Greedy tokens equal the per-token path's.

Batch size, table width and horizon are bucketed to powers of two as in
the JAX server (its jit cache depends on it; here ``_plan_horizon`` and
``commit_horizon`` do).  The page store is updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.kv_tier import (PAGE_DTYPES, PageStore,
                                      PageTableManager, write_slots)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_params


def make_serving_fns(model, mesh=None):
    """(prefill, decode_step) of the dense serving path: the model's own
    methods, run eagerly (the JAX package jits them and donates the
    cache; ``decode_step`` here writes the cache in place).  Sharding
    over a mesh is not ported."""
    if mesh is not None:
        raise NotImplementedError("make_serving_fns over a mesh (sharded "
                                  "serving): not yet ported")
    return model.prefill, model.decode_step


def _pow2(n: int) -> int:
    """Smallest power of two >= n (shape bucketing)."""
    return 1 << max(0, n - 1).bit_length()


def _pow2_floor(n: int) -> int:
    """Largest power of two <= n (horizon bucketing: a tail horizon
    runs as pow2 chunks, e.g. 5 -> 4 then 1)."""
    return 1 << (max(n, 1).bit_length() - 1)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Token selection.  Only greedy (``temperature <= 0``) is ported;
    sampling needs the JAX package's threefry draws, bit for bit."""
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


class PagedServer:
    """Tiered-KV serving for a TransformerLM on one device.

    All layers share one page table: a physical page id addresses the
    stacked KV ``[n_layers, page, Hkv, D]`` of that extent, so tiering
    moves whole stacked pages and a step needs one table per batch.
    ``device`` defaults to ``cuda``; ``params`` must already live there.
    """

    def __init__(self, model, params, *, page_size: int = 16,
                 hbm_pages: int = 64, page_dtype: str = "fp32",
                 device="cuda"):
        if page_dtype not in PAGE_DTYPES:
            raise ValueError(f"page_dtype must be one of {PAGE_DTYPES}, "
                             f"got {page_dtype!r}")
        self.device = resolve_device(device)
        table_dev = params["embed"]["table"].device
        if table_dev.type != self.device.type:
            raise ValueError(f"params live on {table_dev}, the server on "
                             f"{self.device}")
        self.model = model
        self.cfg = model.cfg
        if self.cfg.is_moe:
            raise NotImplementedError("MoE FFN: not yet ported")
        self.params = params
        self._layers = [layer_params(params["layers"], li)
                        for li in range(self.cfg.n_layers)]
        self.dtype = model.compute_dtype
        self.page = page_size
        self.page_dtype = page_dtype
        self.quantized = page_dtype in ("int8", "fp8")
        self.hbm_pages = hbm_pages
        self.store = PageStore(
            n_layers=self.cfg.n_layers, page_size=page_size,
            hbm_pages=hbm_pages, n_kv_heads=self.cfg.n_kv_heads,
            head_dim=self.cfg.hd, dtype=self.dtype, page_dtype=page_dtype,
            device=self.device)
        self.table = PageTableManager(self.store)
        self._seqs: List[int] = []
        self._pending: Dict[int, int] = {}
        # prompts of admissions whose chunked prefill is in flight;
        # _prefill_unmatched marks those whose lazy prefix match has not
        # run yet
        self._prefill_state: Dict[int, np.ndarray] = {}
        self._prefill_unmatched: set = set()
        self.prefill_tokens_computed = 0

    def _to_dev(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.array(arr, order="C")).to(self.device)

    # -- public capacity API -------------------------------------------------

    def pages_needed(self, n_tokens: int) -> int:
        return self.table.pages_needed(n_tokens)

    def sequence_ids(self) -> List[int]:
        return list(self._seqs)

    def pending_tokens(self) -> Dict[int, int]:
        """Next-token (greedy) continuation for each live sequence."""
        return dict(self._pending)

    def set_pending(self, seq_id: int, token: int):
        """Override the token the next decode call feeds ``seq_id``."""
        self._pending[seq_id] = int(token)

    def free_sequence(self, seq_id: int) -> int:
        """Retire a sequence: its pages in both tiers are released.
        Returns the number of pages freed."""
        freed = self.table.free_sequence(seq_id)
        if seq_id in self._seqs:
            self._seqs.remove(seq_id)
        self._pending.pop(seq_id, None)
        self._prefill_state.pop(seq_id, None)
        self._prefill_unmatched.discard(seq_id)
        return freed

    # -- transformer-block halves (shared by the kernel path and the
    #    eager reference; only the attention middle differs) ---------------

    def _attn_inputs(self, lp, h, positions):
        """Pre-norm -> q/k/v projections -> RoPE at ``positions``."""
        cfg = self.cfg
        a = L.apply_norm(lp["attn_norm"], h, cfg.norm)
        q, k, v = L._qkv(lp["attn"], a, cfg)
        if cfg.rope:
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _attn_out_ffn(self, lp, h, o_flat):
        """Attention output-projection residual + FFN residual.
        o_flat: [B, S, H*D]."""
        cfg = self.cfg
        h = h + o_flat @ lp["attn"]["wo"].to(h.dtype)
        m = L.apply_norm(lp["mlp_norm"], h, cfg.norm)
        return h + L.apply_mlp(lp["mlp"], m, cfg.act)

    def _kernel_attention(self, q, li, page_table, lengths):
        """The paged-attention kernel over layer ``li``'s page state: the
        f32 kernel for full-precision stores, the fused-dequant q8
        kernel for int8/fp8 ones."""
        st = self.store.layer_state(li)
        q = q.to(self.dtype).contiguous()
        if self.quantized:
            return ops.paged_attention_q8(q, st["k"], st["v"], st["ks"],
                                          st["vs"], page_table, lengths)
        return ops.paged_attention(q, st["k"], st["v"], page_table, lengths)

    def _logits(self, h):
        cfg = self.cfg
        h = L.apply_norm(self.params["final_norm"], h, cfg.norm)
        return L.unembed(self.params["embed"], self.params.get("lm_head"),
                         h, cfg.tie_embeddings)

    # -- device steps --------------------------------------------------------

    def decode_step(self, page_table, lengths, tokens):
        """One decode step for the whole batch: the horizon loop at H=1.

        page_table: [B, pps] int32 physical ids; lengths: [B] int32
        committed lengths (0 marks a padding slot); tokens: [B] int32.
        Returns logits [B, V] f32.  Appends in place."""
        _, logits = self.decode_horizon_step(
            page_table, lengths, tokens, (lengths > 0).to(torch.int32), -1,
            horizon=1)
        return logits

    def decode_horizon_step(self, page_table, lengths, tokens, budget,
                            eos_id: int, *, horizon: int):
        """``horizon`` fused decode steps: the on-device argmax feeds the
        next step, page slots advance against the reservation
        (``PageTableManager.reserve_horizon``, which ``page_table``
        covers), and EOS/budget masks stop finished sequences.  Rows
        that are done (or padding) append into the sentinel page and
        emit -1.  budget: [B] int32 tokens each sequence may still
        produce; eos_id: -1 disables EOS.

        Returns (emitted [H, B] int32, last step's logits [B, V] f32)."""
        b = tokens.shape[0]
        pps = page_table.shape[1]
        emitted = []
        logits = None
        for _ in range(horizon):
            valid = (budget > 0) & (lengths > 0)
            pos = lengths[:, None]
            # finished rows may sit one page past their reservation;
            # their append is dropped, the clamp only keeps the gather
            # inside the table
            pidx = torch.clamp(lengths // self.page, max=pps - 1)
            offs = lengths % self.page
            phys = page_table.gather(1, pidx[:, None].long())[:, 0]
            tgt = torch.where(valid, phys, self.hbm_pages)
            new_lengths = lengths + valid.to(torch.int32)

            h = L.embed_tokens(self.params["embed"], tokens[:, None],
                               self.dtype)
            for li, lp in enumerate(self._layers):
                q, k, v = self._attn_inputs(lp, h, pos)
                self.store.append(li, tgt, offs, k[:, 0], v[:, 0])
                o = self._kernel_attention(q[:, 0], li, page_table,
                                           new_lengths)
                h = self._attn_out_ffn(lp, h, o.reshape(b, 1, -1))
            logits = self._logits(h)[:, 0]
            nxt = logits.argmax(dim=-1).to(torch.int32)
            emitted.append(torch.where(valid, nxt, -1))
            # the emitted token used one budget slot; EOS zeroes the rest
            budget = torch.where(valid & (nxt == eos_id), 0,
                                 budget - valid.to(torch.int32))
            tokens = torch.where(valid, nxt, tokens)
            lengths = new_lengths
        return torch.stack(emitted), logits

    def prefill_chunk_step(self, page_row: np.ndarray, tokens: np.ndarray,
                           start: int, n_valid: int):
        """One prefill chunk: append the chunk's K/V into the sequence's
        pages, then attend every chunk position over the paged context
        (cached prefix + the chunk, causally), every position
        reading the one page row through an expanded (stride-0) table.

        page_row: [pps] int32 physical ids covering [0, start +
        n_valid); tokens: [1, C] int32 (C a pow2 bucket, garbage past
        n_valid); start: committed tokens before this chunk.  Returns
        the last valid position's logits [V] f32."""
        c = tokens.shape[1]
        pps = page_row.shape[0]
        pos_i = np.arange(c, dtype=np.int32)
        wpos = start + pos_i                          # absolute positions
        valid_w = pos_i < n_valid
        pidx = np.clip(wpos // self.page, 0, pps - 1)
        phys_w = np.where(valid_w, page_row[pidx], self.hbm_pages)
        # per-position causal extent; 0 fully masks padding queries
        lengths_q = np.where(valid_w, wpos + 1, 0).astype(np.int32)

        positions = self._to_dev(wpos[None, :])
        tgt = self._to_dev(phys_w)
        offs = self._to_dev(wpos % self.page)
        lengths_t = self._to_dev(lengths_q)
        # one row seen by every position (stride 0): the kernels' chunk form
        table_t = self._to_dev(page_row)[None, :].expand(c, pps)
        h = L.embed_tokens(self.params["embed"], self._to_dev(tokens),
                           self.dtype)
        for li, lp in enumerate(self._layers):
            q, k, v = self._attn_inputs(lp, h, positions)
            self.store.append(li, tgt, offs, k[0], v[0])
            o = self._kernel_attention(q[0], li, table_t, lengths_t)
            h = self._attn_out_ffn(lp, h, o.reshape(1, c, -1))
        return self._logits(h[:, n_valid - 1:n_valid])[0, 0]

    # -- request handling ----------------------------------------------------

    def begin_request(self, seq_id: int, prompt: np.ndarray) -> int:
        """Open an admission: queue the prompt for :meth:`prefill_chunk`.
        The cached-prefix match runs lazily at the first chunk.  Returns
        the prompt tokens the cache covers right now."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.shape[0] < 1:
            raise ValueError("empty prompt")
        self.table.add_sequence(seq_id)
        self._seqs.append(seq_id)
        self._prefill_state[seq_id] = prompt
        self._prefill_unmatched.add(seq_id)
        return self.table.probe_prefix(seq_id, prompt)

    def prefill_pending(self, seq_id: int) -> int:
        """Prompt tokens still to prefill (0 = admission complete)."""
        prompt = self._prefill_state.get(seq_id)
        if prompt is None:
            return 0
        return int(prompt.shape[0]) - self.table.length(seq_id)

    def prefill_chunk(self, seq_id: int, chunk: Optional[int] = None):
        """Run ONE prefill chunk of at most ``chunk`` tokens (default:
        the whole remaining suffix), bucketed up to a power of two, with
        the page row padded to a pow2 width.  Returns the last prompt
        position's logits [V] when this chunk completes the prompt,
        else None."""
        prompt = self._prefill_state[seq_id]
        s = int(prompt.shape[0])
        if seq_id in self._prefill_unmatched:
            self._prefill_unmatched.discard(seq_id)
            try:
                self.table.match_prefix(seq_id, prompt)
            except Exception:
                self.free_sequence(seq_id)
                raise
        start = self.table.length(seq_id)
        c = s - start if chunk is None else min(int(chunk), s - start)
        try:
            try:
                rows = self.table.ensure_resident(seq_id, pin=True,
                                                  n_tokens=start + c)
                if start % self.page:
                    # the chunk's first write lands mid-page: CoW-split a
                    # shared prefix tail before the device touches it
                    self.table.make_writable(seq_id, start // self.page)
                    rows = self.table.row(seq_id, len(rows))
            finally:
                self.table.unpin_all()
            row = np.zeros((_pow2(len(rows)),), np.int32)
            row[:len(rows)] = rows
            tokens = np.zeros((1, _pow2(c)), np.int32)
            tokens[0, :c] = prompt[start:start + c]
            logits = self.prefill_chunk_step(row, tokens, start, c)
        except Exception:
            # a rejected admission must not leak window pages or leave a
            # zero-length ghost in the live set
            self.free_sequence(seq_id)
            raise
        self.table.set_length(seq_id, start + c)
        self.prefill_tokens_computed += c
        if start + c < s:
            return None
        del self._prefill_state[seq_id]
        self.table.register_prefix(seq_id, prompt)
        self._pending[seq_id] = int(logits.argmax())
        return logits

    def add_request(self, seq_id: int, prompt: np.ndarray, *,
                    chunk: Optional[int] = None):
        """Admit a sequence: cached-prefix match, then chunked prefill of
        the uncached suffix.  Returns the last prompt position's logits
        [V]."""
        self.begin_request(seq_id, prompt)
        logits = None
        while logits is None:
            logits = self.prefill_chunk(seq_id, chunk)
        return logits

    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from the prefix
        cache instead of computed."""
        saved = self.table.stats.prefix_tokens
        total = saved + self.prefill_tokens_computed
        return saved / total if total else 0.0

    # -- one committed batched step ------------------------------------------

    def _plan_step(self, seqs: List[int]):
        """Host-side page management for one decode step: every active
        page resident + pinned, then the padded device inputs."""
        try:
            rows = [self.table.prepare_append(s) for s in seqs]
        except Exception:
            self.table.unpin_all()
            raise
        lengths = [self.table.length(s) for s in seqs]
        pps = _pow2(max(len(r) for r in rows))
        b2 = _pow2(len(seqs))
        table = np.zeros((b2, pps), np.int32)
        for i, r in enumerate(rows):
            table[i, :len(r)] = r
        lens = np.zeros((b2,), np.int32)
        lens[:len(seqs)] = lengths
        return self._to_dev(table), self._to_dev(lens)

    def step_batch(self, tokens: Dict[int, int]):
        """Feed one token per sequence through one decode step and commit
        the appends.  Returns (seq_ids, logits [B, V])."""
        seqs = list(tokens)
        page_table, lengths = self._plan_step(seqs)
        try:
            toks = np.zeros((lengths.shape[0],), np.int32)
            toks[:len(seqs)] = [tokens[s] for s in seqs]
            logits = self.decode_step(page_table, lengths, self._to_dev(toks))
            for s in seqs:
                self.table.commit_append(s)
        finally:
            self.table.unpin_all()
        return seqs, logits[:len(seqs)]

    def step(self, tokens: Dict[int, int]) -> Dict[int, torch.Tensor]:
        """Dict-shaped :meth:`step_batch`: {seq_id: logits [V]}."""
        seqs, logits = self.step_batch(tokens)
        return {s: logits[i] for i, s in enumerate(seqs)}

    def step_reference(self, tokens: Dict[int, int]) -> torch.Tensor:
        """Eager spec of one decode step: per-layer loop, one scalar
        append per sequence into a *copy* of the layer's pages, a page
        table rebuilt per layer, and the plain attention
        (``kernels.ref``), never the kernel.  Does NOT commit and leaves
        the store untouched.  Returns logits [B, V] in ``tokens``
        order."""
        seqs = list(tokens)
        dev = self.device
        try:
            rows = [self.table.prepare_append(s) for s in seqs]
            lengths = [self.table.length(s) for s in seqs]
            pos = torch.tensor([[n] for n in lengths], dtype=torch.int32,
                               device=dev)
            b = len(seqs)
            toks = torch.tensor([tokens[s] for s in seqs], dtype=torch.int32,
                                device=dev)
            new_lengths = torch.tensor([n + 1 for n in lengths],
                                       dtype=torch.int32, device=dev)
            h = L.embed_tokens(self.params["embed"], toks[:, None],
                               self.dtype)
            for li, lp in enumerate(self._layers):
                st = {n: t.clone()
                      for n, t in self.store.layer_state(li).items()}
                q, k, v = self._attn_inputs(lp, h, pos)
                for bi, (n, row) in enumerate(zip(lengths, rows)):
                    write_slots(st, torch.tensor([row[n // self.page]],
                                                 device=dev),
                                torch.tensor([n % self.page], device=dev),
                                k[bi:bi + 1, 0], v[bi:bi + 1, 0],
                                self.store.qmax)
                max_pages = max(len(r) for r in rows)
                page_table = torch.tensor(
                    [r + [0] * (max_pages - len(r)) for r in rows],
                    dtype=torch.int32, device=dev)
                qd = q[:, 0].to(self.dtype)
                if self.quantized:
                    o = ops.ref.paged_attention_q8_ref(
                        qd, st["k"], st["v"], st["ks"], st["vs"], page_table,
                        new_lengths)
                else:
                    o = ops.ref.paged_attention_ref(qd, st["k"], st["v"],
                                                    page_table, new_lengths)
                h = self._attn_out_ffn(lp, h, o.reshape(b, 1, -1))
            logits = self._logits(h)[:, 0]
        finally:
            self.table.unpin_all()
        return logits

    # -- one committed horizon batch -----------------------------------------

    def _plan_horizon(self, seqs: List[int], budgets: Dict[int, int]):
        """Host-side page management for one fused horizon: reserve + pin
        every page the horizon can touch, then the padded device
        inputs (pow2 batch and table width)."""
        try:
            rows = [self.table.reserve_horizon(s, budgets[s]) for s in seqs]
        except Exception:
            # roll every reservation back to the committed lengths
            for s in seqs:
                self.table.commit_horizon(s, 0)
            self.table.unpin_all()
            raise
        lengths = [self.table.length(s) for s in seqs]
        pps = _pow2(max(len(r) for r in rows))
        b2 = _pow2(len(seqs))
        table = np.zeros((b2, pps), np.int32)
        for i, r in enumerate(rows):
            table[i, :len(r)] = r
        lens = np.zeros((b2,), np.int32)
        lens[:len(seqs)] = lengths
        buds = np.zeros((b2,), np.int32)
        buds[:len(seqs)] = [budgets[s] for s in seqs]
        return self._to_dev(table), self._to_dev(lens), self._to_dev(buds)

    def horizon_batch(self, tokens: Dict[int, int],
                      budgets: Dict[int, int], horizon: int,
                      eos_id: Optional[int] = None) -> Dict[int, List[int]]:
        """Run one fused decode horizon over ``tokens`` ({seq: pending
        token}) and commit the appends.  ``budgets[s]`` caps how many
        tokens ``s`` may produce; ``eos_id`` stops a sequence on device.
        The horizon is bucketed DOWN to a power of two.  Returns
        {seq_id: emitted tokens}, from one device->host transfer."""
        seqs = list(tokens)
        h_run = _pow2_floor(min(horizon, max(budgets[s] for s in seqs)))
        page_table, lengths, buds = self._plan_horizon(
            seqs, {s: min(budgets[s], h_run) for s in seqs})
        try:
            toks = np.zeros((lengths.shape[0],), np.int32)
            toks[:len(seqs)] = [tokens[s] for s in seqs]
            emitted, _ = self.decode_horizon_step(
                page_table, lengths, self._to_dev(toks), buds,
                -1 if eos_id is None else int(eos_id), horizon=h_run)
            emitted = emitted.cpu().numpy()     # THE one transfer
            out = {}
            for i, s in enumerate(seqs):
                got = [int(t) for t in emitted[:, i] if t >= 0]
                out[s] = got
                # committed appends == emitted tokens; the unused tail of
                # the reservation rolls back
                self.table.commit_horizon(s, len(got))
        except Exception:
            for s in seqs:
                if s in self._seqs:
                    self.table.commit_horizon(s, 0)
            raise
        finally:
            self.table.unpin_all()
        return out

    # -- decode loop ---------------------------------------------------------

    def decode(self, n_tokens: int, seqs: Optional[List[int]] = None, *,
               horizon: Optional[int] = None,
               eos_id: Optional[int] = None,
               budgets: Optional[Dict[int, int]] = None,
               sampling: Optional[SamplingConfig] = None,
               speculative: bool = False) -> Dict[int, list]:
        """Greedy batched decode across live sequences (or a subset).

        ``horizon=None`` is the per-token path: one host interaction
        (plan, step, argmax transfer) per token.  ``horizon=H`` runs the
        fused path, H tokens per host interaction, token-for-token
        identical.  ``budgets``/``eos_id`` stop sequences early on both
        paths."""
        if speculative:
            raise NotImplementedError("speculative decoding: not yet ported")
        if sampling is not None and not sampling.greedy:
            raise NotImplementedError("sampling (temperature > 0): not yet "
                                      "ported")
        active = self._seqs if seqs is None else seqs
        out = {s: [] for s in active}
        # pull spilled pages of the activating batch before the loop
        for s in active:
            self.table.prefetch(s)
        cur = {s: self._pending.get(s, 0) for s in active}
        remaining = {s: min(n_tokens, budgets[s]) if budgets else n_tokens
                     for s in active}
        live = [s for s in active if remaining[s] > 0]
        if horizon is None:
            while live:
                seqs_b, logits = self.step_batch({s: cur[s] for s in live})
                nxt = logits.argmax(dim=-1).cpu().numpy()
                for i, s in enumerate(seqs_b):
                    cur[s] = int(nxt[i])
                    out[s].append(cur[s])
                    remaining[s] -= 1
                    if eos_id is not None and cur[s] == eos_id:
                        remaining[s] = 0
                live = [s for s in live if remaining[s] > 0]
            self._pending.update(cur)
            return out
        while live:
            got = self.horizon_batch(
                {s: cur[s] for s in live},
                {s: remaining[s] for s in live},
                min(horizon, max(remaining[s] for s in live)),
                eos_id=eos_id)
            for s in live:
                out[s].extend(got[s])
                remaining[s] -= len(got[s])
                if got[s]:
                    cur[s] = got[s][-1]
                if eos_id is not None and got[s] and got[s][-1] == eos_id:
                    remaining[s] = 0          # stopped on device
            live = [s for s in live if remaining[s] > 0]
        self._pending.update(cur)
        return out

    # -- telemetry -----------------------------------------------------------

    def tier_stats(self) -> Dict[str, int]:
        agg = dict(vars(self.table.stats))
        agg["residency"] = self.table.residency()
        agg["page_bytes"] = self.store.page_bytes()
        agg["kv_bytes_moved"] = agg["bytes_in"] + agg["bytes_out"]
        return agg
