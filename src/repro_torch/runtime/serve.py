"""Serving runtime on torch: the dense path (``make_serving_fns``) and
the paged-KV ``PagedServer``, with token sampling and speculative
decoding.

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
    with the token selection kept on the device, against pages reserved
    for the whole horizon, and moves one [H, B] tensor of emitted tokens
    to the host per horizon.  Greedy tokens equal the per-token path's;
  * token selection is greedy argmax or, with a ``SamplingConfig`` of
    temperature > 0, Gumbel-max over the temperature-scaled, top-p
    filtered distribution, drawn at ``fold_in(fold_in(key(seed),
    sequence id), position)`` by the threefry generator of
    ``runtime.prng``, bit for bit the JAX package's draws;
  * speculative decoding (``decode(speculative=True)``): an n-gram
    drafter (``draft_ngram``) proposes up to H-1 tokens from each
    sequence's own history, one verify pass runs the H fed positions of
    every sequence as B*H decode-shaped query rows (each over its
    sequence's page row, repeated in a materialised table, so the
    kernels' decode form runs), acceptance keeps the longest matched
    prefix plus the token at the first mismatch, and ``commit_horizon``
    rolls back the rejected tail's pages.

Batch size, table width and horizon are bucketed to powers of two as in
the JAX server (its jit cache depends on it; here ``_plan_horizon`` and
``commit_horizon`` do).  The page store is updated in place.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.kv_tier import (PAGE_DTYPES, PageStore,
                                      PageTableManager, write_slots)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_params
from repro_torch.runtime.prng import fold_in, gumbel, prng_key

NEG_INF = -1e30


def paged_attention_partial(q, k_pages, v_pages, local_table, col_owned,
                            lengths, k_scale=None, v_scale=None):
    """Paged decode attention returning online-softmax partials: the
    device contract of pool serving (the reference's
    ``paged_attention_partial``).  Scores only the table columns this
    node owns, folds them with an online softmax and returns the
    un-normalised ``(acc, m, l)``, which :func:`combine_partials` merges
    across nodes exactly (on one node :func:`normalize_partials` closes
    it).  Plain PyTorch; on the card the pool form of the
    paged-attention kernels computes the same partials
    (``kernels.paged_attention.pool_partials``).

    q: [B, H, D]; k_pages/v_pages: the node's *local* [P_node, page,
    Hkv, D]; local_table: [B, pps] local physical ids (garbage where not
    owned); col_owned: [B, pps] bool; lengths: [B] post-append lengths;
    ``k_scale``/``v_scale`` ([P_node, page, Hkv] f32, quantized stores
    only).  Returns (acc [B, H, D] f32, m [B, H] f32, l [B, H] f32); a
    row with nothing owned is (0, NEG_INF, 0)."""
    return ops.ref.paged_partials_ref(q, k_pages, v_pages, local_table,
                                      lengths, k_scale, v_scale, col_owned)


def combine_partials(acc, m, l):
    """Exact merge of per-node online-softmax partials, the node axis
    leading (one card holds every node, so no collective): rebase every
    node's accumulator to the global max and sum.  acc [N, B, H, D], m/l
    [N, B, H] -> [B, H, D].  Nodes owning nothing contribute (0,
    NEG_INF, 0) and vanish; a fully-masked (padding) row ends with l ==
    0 and yields 0, the kernels' ``acc / max(l, 1e-30)`` convention."""
    m_glob = m.amax(dim=0)
    scale = torch.exp(m - m_glob)
    l_glob = (l * scale).sum(dim=0)
    acc_glob = (acc * scale[..., None]).sum(dim=0)
    return acc_glob / torch.clamp(l_glob, min=1e-30)[..., None]


def normalize_partials(acc, m, l):
    """Single-node closure of the partial contract: with every page
    owned locally, normalizing the accumulator *is* the full softmax
    (``acc / max(l, 1e-30)``)."""
    del m  # the local max cancels in acc / l
    return acc / torch.clamp(l, min=1e-30)[..., None]


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
    """On-device token selection, threaded through ``decode`` /
    ``horizon_batch`` / ``spec_horizon_batch``.

    ``temperature <= 0`` is greedy argmax, the default.  ``temperature >
    0`` samples on the device by Gumbel-max over the temperature-scaled,
    top-p-filtered distribution; the draw of the token at position p of
    sequence s is keyed by ``fold_in(fold_in(key(seed), s), p)``, so it
    is a pure function of (seed, sequence, position): the same on every
    path (per-token, horizon, speculative, re-prefilled)."""
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingConfig()


def _f32(x, device) -> torch.Tensor:
    """A float32 scalar on ``device``, made by a fill (no host copy, no
    stream sync): a divisor on the card keeps torch from multiplying by
    a reciprocal, as it does for a host scalar."""
    return torch.full((), x, dtype=torch.float32, device=device)


def sampling_log_probs(logits, temperature, top_p):
    """Log-probs of the temperature/top-p target distribution.

    ``logits`` [..., V].  Tokens outside the nucleus (the smallest
    probability-sorted set with mass >= ``top_p``; every token at the
    cutoff probability kept) go to NEG_INF and the rest renormalise.
    Speculative acceptance is correct against exactly this
    distribution."""
    dev = logits.device
    t = torch.clamp(_f32(temperature, dev), min=1e-6)
    lp = torch.log_softmax(logits.float() / t, dim=-1)
    p = torch.exp(lp)
    srt = torch.sort(p, dim=-1, descending=True).values
    mass_before = torch.cumsum(srt, dim=-1) - srt
    cut = torch.where(mass_before < _f32(top_p, dev), srt,
                      _f32(float("inf"), dev)).amin(dim=-1, keepdim=True)
    lp = torch.where(p >= cut, lp, _f32(NEG_INF, dev))
    return lp - torch.logsumexp(lp, dim=-1, keepdim=True)


def token_scores(logits, sampling, key, streams, positions):
    """Scores whose argmax is the selected token, on ``logits``' device:
    the logits themselves when ``sampling`` is greedy (no sort, no draw),
    else ``sampling_log_probs + gumbel`` with one key a row,
    ``fold_in(fold_in(key, stream), position)``.  logits [..., V];
    streams and positions integer tensors broadcasting to [...]; key
    [2] int64 (``prng.prng_key``)."""
    if sampling is None or sampling.greedy:
        return logits
    lp = sampling_log_probs(logits, sampling.temperature, sampling.top_p)
    keys = fold_in(fold_in(key, streams), positions)
    return lp + gumbel(keys, (logits.shape[-1],))


def sampled_token(logits, sampling, stream: int, position: int) -> int:
    """The token at absolute ``position`` of sequence ``stream``, drawn
    from ``logits`` [V] under ``sampling`` with the key the device
    sampler uses there (greedy: argmax).  A scheduler selects the token
    after a prefill with it, so a re-prefilled sequence continues as the
    uninterrupted run would.  Runs on ``logits``' device."""
    row = torch.as_tensor(logits).reshape(-1)
    key = (None if sampling is None or sampling.greedy else
           prng_key(sampling.seed, row.device))
    scores = token_scores(row, sampling, key, int(stream) & 0x7FFFFFFF,
                          int(position))
    return int(scores.argmax())


# n-gram drafter tuning: a candidate site must match at least
# SPEC_MIN_MATCH trailing history tokens, and match quality is scored up
# to SPEC_MAX_MATCH trailing tokens
SPEC_MIN_MATCH = 3
SPEC_MAX_MATCH = 8


def draft_ngram(hist, hist_len, n_draft: int):
    """N-gram / prompt-lookup drafter over each sequence's own history.

    Finds the earlier site whose trailing tokens agree with the
    history's suffix on the longest run (scored up to
    ``SPEC_MAX_MATCH``, at least ``SPEC_MIN_MATCH``; sites with more
    successor tokens rank first, then the longer match, then the later
    site) and proposes the tokens that followed it.

    hist: [B, T] int32 (prompt + generated incl. the pending token,
    garbage past ``hist_len``); hist_len: [B] int32.  Returns
    [B, n_draft] int32 candidates, -1 where nothing matched (a -1 never
    equals a token, so the verify pass rejects it)."""
    b, t = hist.shape
    dev = hist.device
    hist = hist.long()
    hl = hist_len.long()[:, None]
    ar = torch.arange(t, device=dev)[None, :]
    k = min(SPEC_MAX_MATCH, t)
    # suffix tokens newest-first: last_js[:, j] = hist[hl - 1 - j]
    idx = torch.clamp(hl - 1 - torch.arange(k, device=dev)[None, :], 0,
                      t - 1)
    last_js = hist.gather(1, idx)                            # [B, K]
    run = torch.ones((b, t), dtype=torch.bool, device=dev)
    mlen = torch.zeros((b, t), dtype=torch.long, device=dev)
    for j in range(k):
        # hj[:, i] = hist[:, i - j] (the token j back from site i)
        hj = (torch.nn.functional.pad(hist, (j, 0), value=-1)[:, :t]
              if j else hist)
        run = run & (hj == last_js[:, j:j + 1]) & (ar >= j) & (hl - 1 - j >= 0)
        mlen = mlen + run.long()
    valid = (mlen >= SPEC_MIN_MATCH) & (ar >= 1) & (ar < hl - 1)
    # successor tokens available after site i: the draft it can fill
    runway = torch.clamp(hl - 1 - ar, 0, n_draft)
    score = torch.where(valid, (runway * (SPEC_MAX_MATCH + 1) + mlen) * t + ar,
                        -1)
    best = score.amax(dim=1)                                 # [B]
    match = torch.where(best >= 0, best % t, -1)
    di = match[:, None] + 1 + torch.arange(n_draft, device=dev)[None, :]
    ok = (match >= 1)[:, None] & (di < hl)
    cand = hist.gather(1, torch.clamp(di, 0, t - 1))
    return torch.where(ok, cand, -1).to(torch.int32)


class PagedServer:
    """Tiered-KV serving for a TransformerLM (dense or MoE FFN) on one
    device.

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
        self.params = params
        self._layers = [layer_params(params["layers"], li)
                        for li in range(self.cfg.n_layers)]
        self.dtype = model.compute_dtype
        self.page = page_size
        self.page_dtype = page_dtype
        self.quantized = page_dtype in ("int8", "fp8")
        self.hbm_pages = hbm_pages
        self.store = self._new_store()
        self.table = self._new_table()
        self._seqs: List[int] = []
        self._pending: Dict[int, int] = {}
        # prompts of admissions whose chunked prefill is in flight;
        # _prefill_unmatched marks those whose lazy prefix match has not
        # run yet
        self._prefill_state: Dict[int, np.ndarray] = {}
        self._prefill_unmatched: set = set()
        self.prefill_tokens_computed = 0
        # prompt + generated (incl. pending) tokens of each live sequence:
        # the drafter's lookup corpus, uploaded per speculative pass
        self._history: Dict[int, List[int]] = {}
        self.spec_lookup_window = 256
        # adaptive gate: a rolling acceptance-rate EMA below the floor
        # routes passes to the plain horizon, every spec_probe_every-th
        # gated pass still speculates (a probe that can reopen it)
        self.spec_alpha_floor = 0.7
        self.spec_probe_every = 16
        self.spec_stats: Dict[str, object] = {}
        self.reset_speculation_stats()

    # -- store / table factories (PoolServer overrides the table's) ---------

    def _new_store(self) -> PageStore:
        return PageStore(
            n_layers=self.cfg.n_layers, page_size=self.page,
            hbm_pages=self.hbm_pages, n_kv_heads=self.cfg.n_kv_heads,
            head_dim=self.cfg.hd, dtype=self.dtype,
            page_dtype=self.page_dtype, device=self.device)

    def _new_table(self) -> PageTableManager:
        return PageTableManager(self.store)

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
        """Override the token the next decode call feeds ``seq_id`` (a
        scheduler that selects the token after prefill host-side, with
        ``sampled_token``, reports that one).  The drafter history's
        entry for the old pending token is rewritten to match."""
        tok = int(token)
        hist = self._history.get(seq_id)
        if hist and hist[-1] == self._pending.get(seq_id):
            hist[-1] = tok
        self._pending[seq_id] = tok

    def free_sequence(self, seq_id: int) -> int:
        """Retire a sequence: its pages in both tiers are released.
        Returns the number of pages freed."""
        freed = self.table.free_sequence(seq_id)
        if seq_id in self._seqs:
            self._seqs.remove(seq_id)
        self._pending.pop(seq_id, None)
        self._prefill_state.pop(seq_id, None)
        self._prefill_unmatched.discard(seq_id)
        self._history.pop(seq_id, None)
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
        """Attention output-projection residual + FFN residual (an MoE
        FFN never drops a token here: ``no_drop``, as in the reference).
        o_flat: [B, S, H*D]."""
        cfg = self.cfg
        h = h + o_flat @ lp["attn"]["wo"].to(h.dtype)
        m = L.apply_norm(lp["mlp_norm"], h, cfg.norm)
        if cfg.is_moe:
            return h + L.apply_moe(lp["mlp"], m, cfg, no_drop=True)[0]
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
                            eos_id: int, key=None, sampling=None,
                            streams=None, *, horizon: int):
        """``horizon`` fused decode steps: the token selected on the
        device feeds the next step, page slots advance against the
        reservation (``PageTableManager.reserve_horizon``, which
        ``page_table`` covers), and EOS/budget masks stop finished
        sequences.  Rows that are done (or padding) append into the
        sentinel page and emit -1.  budget: [B] int32 tokens each
        sequence may still produce; eos_id: -1 disables EOS.

        Selection is greedy argmax unless ``sampling`` has temperature >
        0; then row b's token at 1-based position p (its new length) is
        drawn with ``fold_in(fold_in(key, streams[b]), p)``
        (:meth:`token_scores`), so it depends on (seed, sequence,
        position) only, not on batch slot, horizon or pass.

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
            nxt = self.token_scores(logits, sampling, key, streams,
                                    new_lengths).argmax(dim=-1).to(torch.int32)
            emitted.append(torch.where(valid, nxt, -1))
            # the emitted token used one budget slot; EOS zeroes the rest
            budget = torch.where(valid & (nxt == eos_id), 0,
                                 budget - valid.to(torch.int32))
            tokens = torch.where(valid, nxt, tokens)
            lengths = new_lengths
        return torch.stack(emitted), logits

    def token_scores(self, logits, sampling, key, streams, positions):
        """The scores the device steps select tokens by
        (:func:`token_scores`); a method so that a caller can observe
        them on one server."""
        return token_scores(logits, sampling, key, streams, positions)

    def decode_spec_step(self, page_table, lengths, tokens, budget,
                         eos_id: int, hist, hist_len, key=None,
                         sampling=None, streams=None, *, horizon: int):
        """One speculative draft-verify pass.

        ``draft_ngram`` proposes ``horizon - 1`` candidates a sequence
        from its history table (hist [B, T], hist_len [B]); the fed block
        ``[pending, d_1 .. d_{H-1}]`` runs the layer stack as B*H
        decode-shaped query rows, row (b, j) at position ``lengths[b] +
        j`` with causal length ``lengths[b] + j + 1``, each over sequence
        b's page row (the table is materialised, one row a query row, so
        the kernels take it as their decode form).  Position j's
        selection judges candidate ``d_{j+1}``: greedy accepts while the
        argmax equals it; sampling draws the target at (stream, position
        j + 1) with the key the plain horizon uses there and accepts iff
        the candidate equals it (Gumbel coupling: rejection sampling for
        a point-mass draft, and the sampled stream equals the plain
        path's).  The longest accepted prefix plus the token at the
        first mismatch is emitted, the rest is -1, and positions past a
        sequence's budget append nothing (they hold no reserved page).

        Other arguments as :meth:`decode_horizon_step`.  Returns packed
        [horizon + 1, B] int32: the emitted rows, then each sequence's
        drafted-candidate count."""
        b = tokens.shape[0]
        pps = page_table.shape[1]
        hzn = horizon
        dev = tokens.device
        draft = draft_ngram(hist, hist_len, hzn - 1)            # [B, H-1]
        n_drafted = (draft >= 0).sum(dim=1).to(torch.int32)
        fed = torch.cat([tokens[:, None], torch.clamp(draft, min=0)], dim=1)
        steps = torch.arange(hzn, dtype=torch.int32, device=dev)[None, :]
        pos = lengths[:, None] + steps                          # [B, H]
        # appends stay inside the reservation: a position past the
        # budget was never reserved a page, so it must not scatter
        append_ok = (steps < budget[:, None]) & (lengths[:, None] > 0)
        pidx = torch.clamp(pos // self.page, 0, pps - 1)
        offs = (pos % self.page).reshape(-1)
        phys = page_table.gather(1, pidx.long())
        tgt = torch.where(append_ok, phys, self.hbm_pages).reshape(-1)
        # per-position causal extent; 0 fully masks dead positions
        row_lengths = torch.where(append_ok, pos + 1, 0).reshape(-1)
        # one materialised row a query row: an expanded (stride-0) table
        # would take the kernels' chunk form, which reads one sequence
        rows_table = page_table.repeat_interleave(hzn, dim=0)
        h = L.embed_tokens(self.params["embed"], fed, self.dtype)
        for li, lp in enumerate(self._layers):
            q, k, v = self._attn_inputs(lp, h, pos)
            self.store.append(li, tgt, offs, k.reshape(b * hzn, *k.shape[2:]),
                              v.reshape(b * hzn, *v.shape[2:]))
            o = self._kernel_attention(q.reshape(b * hzn, *q.shape[2:]), li,
                                       rows_table, row_lengths)
            h = self._attn_out_ffn(lp, h, o.reshape(b, hzn, -1))
        logits = self._logits(h)                                # [B, H, V]
        # the emission of position j lands at 1-based position pos + 1
        out_tok = self.token_scores(logits, sampling, key,
                                    None if streams is None
                                    else streams[:, None],
                                    pos + 1).argmax(dim=-1).to(torch.int32)
        # the candidate position j verifies is d_{j+1}; the last position
        # has none (its emission is the bonus token)
        d_next = torch.cat([draft, torch.full((b, 1), -1, dtype=torch.int32,
                                              device=dev)], dim=1)
        accept = (out_tok == d_next) & (d_next >= 0)
        # position j emits iff every earlier position accepted its
        # candidate, stayed under budget and did not emit EOS
        live0 = (budget > 0) & (lengths > 0)
        cont = accept & (out_tok != eos_id) & (steps + 1 < budget[:, None])
        chain = torch.cumprod(cont.to(torch.int32), dim=1)
        ok = live0[:, None] & torch.cat(
            [torch.ones((b, 1), dtype=torch.bool, device=dev),
             chain[:, :-1].bool()], dim=1)
        emitted = torch.where(ok, out_tok, -1).to(torch.int32)
        return torch.cat([emitted.T, n_drafted[None, :]], dim=0)

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
        self._history[seq_id] = prompt.tolist()
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
        # the pending token is the first generated one: it is fed (so the
        # drafter sees it) before it is re-emitted
        self._history[seq_id].append(self._pending[seq_id])
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

    def _stream_ids(self, seqs, b2: int) -> torch.Tensor:
        """[b2] int32 sampling-stream ids: the sequence id, stable across
        re-prefill and independent of batch slot (padding rows never
        sample; any id works)."""
        streams = np.zeros((b2,), np.int32)
        streams[:len(seqs)] = [int(s) & 0x7FFFFFFF for s in seqs]
        return self._to_dev(streams)

    def horizon_batch(self, tokens: Dict[int, int],
                      budgets: Dict[int, int], horizon: int,
                      eos_id: Optional[int] = None,
                      sampling: Optional[SamplingConfig] = None,
                      _key=None) -> Dict[int, List[int]]:
        """Run one fused decode horizon over ``tokens`` ({seq: pending
        token}) and commit the appends.  ``budgets[s]`` caps how many
        tokens ``s`` may produce; ``eos_id`` stops a sequence on device.
        ``sampling`` selects greedy argmax (default) or temperature/top-p
        sampling; ``_key`` overrides the PRNG key (``decode`` passes one
        for every pass).  The horizon is bucketed DOWN to a power of two.
        Returns {seq_id: emitted tokens}, from one device->host
        transfer."""
        sampling = sampling or GREEDY
        seqs = list(tokens)
        if _key is None:
            _key = prng_key(sampling.seed, self.device)
        h_run = _pow2_floor(min(horizon, max(budgets[s] for s in seqs)))
        page_table, lengths, buds = self._plan_horizon(
            seqs, {s: min(budgets[s], h_run) for s in seqs})
        try:
            b2 = lengths.shape[0]
            toks = np.zeros((b2,), np.int32)
            toks[:len(seqs)] = [tokens[s] for s in seqs]
            emitted, _ = self.decode_horizon_step(
                page_table, lengths, self._to_dev(toks), buds,
                -1 if eos_id is None else int(eos_id), _key, sampling,
                self._stream_ids(seqs, b2), horizon=h_run)
            emitted = emitted.cpu().numpy()     # THE one transfer
            out = {}
            for i, s in enumerate(seqs):
                got = [int(t) for t in emitted[:, i] if t >= 0]
                out[s] = got
                self._history[s].extend(got)
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

    # -- one committed speculative pass --------------------------------------

    def _host_can_draft(self, seq_id: int) -> bool:
        """Host mirror of the drafter's match predicate: does the lookup
        window hold an earlier occurrence of the history's final
        ``SPEC_MIN_MATCH``-gram?  When no live sequence can draft, a pass
        routes to the plain horizon."""
        a = np.asarray(self._history[seq_id][-self.spec_lookup_window:],
                       np.int64)
        if a.shape[0] < SPEC_MIN_MATCH + 1:
            return False
        m = np.ones((a.shape[0] - SPEC_MIN_MATCH,), bool)
        for j in range(SPEC_MIN_MATCH):
            lo, hi = SPEC_MIN_MATCH - 1 - j, a.shape[0] - 1 - j
            m &= a[lo:hi] == a[-1 - j]
        return bool(m.any())

    def spec_horizon_batch(self, tokens: Dict[int, int],
                           budgets: Dict[int, int], horizon: int,
                           eos_id: Optional[int] = None,
                           sampling: Optional[SamplingConfig] = None,
                           _key=None) -> Dict[int, List[int]]:
        """Run one speculative draft-verify pass (arguments as
        :meth:`horizon_batch`) and commit the accepted prefixes.

        The reservation is the plain horizon's; ``commit_horizon`` keeps
        the accepted tokens plus the bonus token and rolls the rejected
        tail's pages back.  The pass routes to :meth:`horizon_batch`
        (counted in ``spec_stats``) when no live sequence can draft, when
        the bucketed horizon is below 2, or when the acceptance EMA is
        below ``spec_alpha_floor`` (then every ``spec_probe_every``-th
        pass still speculates)."""
        sampling = sampling or GREEDY
        seqs = list(tokens)
        if _key is None:
            _key = prng_key(sampling.seed, self.device)
        h_run = _pow2_floor(min(horizon, max(budgets[s] for s in seqs)))
        gated = self.spec_alpha_ema < self.spec_alpha_floor
        if gated:
            self._spec_probe_tick += 1
        if (h_run < 2 or
                (gated and self._spec_probe_tick % self.spec_probe_every)
                or not any(self._host_can_draft(s) for s in seqs)):
            self.spec_stats["fallback_passes"] += 1
            if gated:
                self.spec_stats["gated_passes"] += 1
            return self.horizon_batch(tokens, budgets, horizon,
                                      eos_id=eos_id, sampling=sampling,
                                      _key=_key)
        page_table, lengths, buds = self._plan_horizon(
            seqs, {s: min(budgets[s], h_run) for s in seqs})
        b2 = int(lengths.shape[0])
        w = self.spec_lookup_window
        # a fixed-width table (pow2 of the lookup window) whatever the
        # history's length
        hist = np.full((b2, _pow2(w)), -1, np.int32)
        hlen = np.zeros((b2,), np.int32)
        for i, s in enumerate(seqs):
            hh = self._history[s][-w:]
            hist[i, :len(hh)] = hh
            hlen[i] = len(hh)
        try:
            toks = np.zeros((b2,), np.int32)
            toks[:len(seqs)] = [tokens[s] for s in seqs]
            packed = self.decode_spec_step(
                page_table, lengths, self._to_dev(toks), buds,
                -1 if eos_id is None else int(eos_id), self._to_dev(hist),
                self._to_dev(hlen), _key, sampling,
                self._stream_ids(seqs, b2), horizon=h_run)
            # THE one transfer of the pass: [h_run + 1, B] int32
            packed = packed.cpu().numpy()
            emitted, n_drafted = packed[:-1], packed[-1]
            out = {}
            st = self.spec_stats
            st["passes"] += 1
            for i, s in enumerate(seqs):
                got = [int(t) for t in emitted[:, i] if t >= 0]
                out[s] = got
                self._history[s].extend(got)
                # committed appends == accepted prefix + bonus; the
                # rejected tail of the reservation rolls back here
                self.table.commit_horizon(s, len(got))
                drafted = int(n_drafted[i])
                st["drafted"] += drafted
                st["accepted"] += max(0, min(len(got) - 1, drafted))
                st["emitted"] += len(got)
                st["accepted_len_hist"][len(got)] = \
                    st["accepted_len_hist"].get(len(got), 0) + 1
            # the rolling acceptance EMA drives the gate; a fast one, so
            # a hostile workload closes it within a couple of passes
            pass_drafted = int(n_drafted[:len(seqs)].sum())
            if pass_drafted:
                pass_acc = sum(
                    max(0, min(len(out[s]) - 1, int(n_drafted[i])))
                    for i, s in enumerate(seqs)) / pass_drafted
                self.spec_alpha_ema = (0.5 * self.spec_alpha_ema +
                                       0.5 * pass_acc)
        except Exception:
            for s in seqs:
                if s in self._seqs:
                    self.table.commit_horizon(s, 0)
            raise
        finally:
            self.table.unpin_all()
        return out

    def speculation_stats(self) -> Dict[str, object]:
        """Speculative telemetry: pass and fallback counts, drafted vs
        accepted candidates (``alpha`` = acceptance rate) and the
        emitted-length histogram {tokens a pass: passes}."""
        st = dict(self.spec_stats)
        st["accepted_len_hist"] = dict(st["accepted_len_hist"])
        st["alpha"] = (st["accepted"] / st["drafted"]
                       if st["drafted"] else 0.0)
        return st

    def reset_speculation_stats(self) -> None:
        """Zero the speculative counters and reopen the adaptive gate."""
        self.spec_stats = {
            "passes": 0, "fallback_passes": 0, "gated_passes": 0,
            "drafted": 0, "accepted": 0, "emitted": 0,
            "accepted_len_hist": {}}
        self.spec_alpha_ema = 1.0
        self._spec_probe_tick = 0

    # -- decode loop ---------------------------------------------------------

    def decode(self, n_tokens: int, greedy: Optional[bool] = None,
               seqs: Optional[List[int]] = None, *,
               horizon: Optional[int] = None,
               eos_id: Optional[int] = None,
               budgets: Optional[Dict[int, int]] = None,
               sampling: Optional[SamplingConfig] = None,
               speculative: bool = False) -> Dict[int, list]:
        """Batched decode across live sequences (or a subset).

        ``horizon=None`` is the per-token path: one host interaction
        (plan, step, argmax transfer) per token.  ``horizon=H`` runs the
        fused path, H tokens per host interaction, greedy tokens
        identical.  ``speculative=True`` runs draft-verify passes
        (``horizon`` defaults to 8 and must be >= 2), greedy tokens still
        identical.  ``budgets``/``eos_id`` stop sequences early on every
        path.  ``sampling`` is the token selection (``GREEDY`` when
        omitted); temperature > 0 runs the fused path, at horizon 1 when
        none is given.  ``greedy=`` is deprecated and kept as a shim:
        ``greedy=False`` without a ``sampling`` raises."""
        if greedy is not None:
            warnings.warn(
                "decode(greedy=) is deprecated; pass "
                "sampling=SamplingConfig(temperature=...) instead",
                DeprecationWarning, stacklevel=2)
            if not greedy and sampling is None:
                raise ValueError(
                    "greedy=False no longer selects a sampler; pass "
                    "sampling=SamplingConfig(temperature=..., top_p=...)")
        sampling = sampling or GREEDY
        if speculative:
            if horizon is None:
                horizon = 8
            if horizon < 2:
                raise ValueError("speculative decoding needs horizon >= 2 "
                                 "(one fed token + >=1 draft candidate)")
        elif not sampling.greedy and horizon is None:
            # sampling lives in the fused step: run it at H=1
            horizon = 1
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
                    self._history[s].append(cur[s])
                    remaining[s] -= 1
                    if eos_id is not None and cur[s] == eos_id:
                        remaining[s] = 0
                live = [s for s in live if remaining[s] > 0]
            self._pending.update(cur)
            return out
        # ONE key for every pass: draws are keyed per (sequence,
        # position) inside the step, so a sequence resumed in another
        # batch or pass re-derives the same draws
        base_key = prng_key(sampling.seed, self.device)
        batch_fn = (self.spec_horizon_batch if speculative
                    else self.horizon_batch)
        while live:
            got = batch_fn(
                {s: cur[s] for s in live},
                {s: remaining[s] for s in live},
                min(horizon, max(remaining[s] for s in live)),
                eos_id=eos_id, sampling=sampling, _key=base_key)
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
