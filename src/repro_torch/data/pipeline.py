"""Deterministic sharded data pipeline with straggler mitigation.

A copy of the JAX package's ``data/pipeline.py`` (numpy only): the
port keeps its own, and its batches are bit-equal to the reference's.

Design goals for 1000+ nodes:
  * **Determinism** — batch contents are a pure function of
    (seed, step, shard), so an elastic re-shard or restart replays the
    exact stream with no coordination.
  * **Prefetch** — a background thread keeps ``prefetch_depth`` batches
    ready (hides host-side generation/fetch latency).
  * **Straggler mitigation** — every fetch is issued to a primary and,
    after ``backup_after_ms``, to a backup worker; first result wins
    (the classic tail-latency double-issue).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np


def synthetic_stream(seed: int, step: int, shard: int, *, batch: int,
                     seq_len: int, vocab: int,
                     kind: str = "random") -> Dict[str, np.ndarray]:
    """Pure function of (seed, step, shard) -> one shard's batch.

    kind="learnable": cyclic token runs (next token is predictable), for
    loss-decrease integration tests; kind="random": uniform tokens.
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))
    if kind == "learnable":
        start = rng.integers(0, vocab, size=(batch, 1), dtype=np.int32)
        stride = rng.integers(1, 4, size=(batch, 1), dtype=np.int32)
        pos = np.arange(seq_len, dtype=np.int32)[None, :]
        tokens = (start + stride * pos) % vocab
    else:
        tokens = rng.integers(0, vocab, size=(batch, seq_len),
                              dtype=np.int32)
    labels = np.concatenate(
        [tokens[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
    return {"tokens": tokens, "labels": labels}


class ShardedLoader:
    """Per-host loader for one data shard of the global batch."""

    def __init__(self, *, global_batch: int, seq_len: int, vocab: int,
                 n_shards: int, shard: int, seed: int = 0,
                 prefetch_depth: int = 2,
                 fetch_fn: Optional[Callable] = None,
                 backup_after_ms: float = 50.0, kind: str = "random"):
        assert global_batch % n_shards == 0
        self.batch = global_batch // n_shards
        self.seq_len = seq_len
        self.vocab = vocab
        self.n_shards = n_shards
        self.shard = shard
        self.seed = seed
        self.kind = kind
        self.step = 0
        self.backup_after_ms = backup_after_ms
        self.stats = {"fetches": 0, "backups_issued": 0, "backup_wins": 0}
        self._fetch = fetch_fn or self._default_fetch
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _default_fetch(self, step: int) -> Dict[str, np.ndarray]:
        return synthetic_stream(self.seed, step, self.shard,
                                batch=self.batch, seq_len=self.seq_len,
                                vocab=self.vocab, kind=self.kind)

    # -- straggler-mitigated fetch ------------------------------------------

    def _fetch_with_backup(self, step: int) -> Dict[str, np.ndarray]:
        """Issue to a primary worker; if it exceeds backup_after_ms, issue
        a duplicate to a backup and take whichever finishes first."""
        self.stats["fetches"] += 1
        result: "queue.Queue" = queue.Queue()

        def work(tag):
            try:
                result.put((tag, self._fetch(step)))
            except Exception as e:  # pragma: no cover
                result.put((tag, e))

        t1 = threading.Thread(target=work, args=("primary",), daemon=True)
        t1.start()
        try:
            tag, out = result.get(timeout=self.backup_after_ms / 1e3)
        except queue.Empty:
            self.stats["backups_issued"] += 1
            t2 = threading.Thread(target=work, args=("backup",), daemon=True)
            t2.start()
            tag, out = result.get()
            if tag == "backup":
                self.stats["backup_wins"] += 1
        if isinstance(out, Exception):
            raise out
        return out

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._fetch_with_backup(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def reshard(self, n_shards: int, shard: int) -> "ShardedLoader":
        """Elastic re-partition: same stream semantics under a new mesh."""
        self.close()
        return ShardedLoader(global_batch=self.batch * self.n_shards,
                             seq_len=self.seq_len, vocab=self.vocab,
                             n_shards=n_shards, shard=shard, seed=self.seed,
                             backup_after_ms=self.backup_after_ms,
                             kind=self.kind)

    def close(self):
        self._stop.set()
