"""The port's prefix page cache (``PageTableManager``: ``match_prefix``,
``probe_prefix``, ``prefix_tokens_on_shard``, ``register_prefix``, with
page migration, eviction and a dead shard) in lockstep with the JAX
package's table on the CPU: the same operations on both, the returns,
the index (digest -> page, per shard), page tables and stats equal
after every one.  The prompts share page-aligned and mid-page prefixes,
so partial-page entries are registered, matched and dropped."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.kv_tier import PageStore as JStore  # noqa: E402
from repro.core.kv_tier import PageTableManager as JTable  # noqa: E402
from repro_torch.core.kv_tier import PageStore, PageTableManager  # noqa: E402

PAGE = 4
STORE = dict(n_layers=1, page_size=PAGE, n_kv_heads=1, head_dim=4)


def _tables(hbm_pages, n_shards):
    port = PageTableManager(
        PageStore(**STORE, hbm_pages=hbm_pages, dtype=torch.float32,
                  device="cpu"), n_shards=n_shards)
    ref = JTable(JStore(**STORE, hbm_pages=hbm_pages, dtype=jnp.float32),
                 n_shards=n_shards)
    return port, ref


def _state(t):
    return ([dict(i) for i in t._prefix_index], dict(t._page_digest),
            dict(t._resident), dict(t._lengths), dict(t._rc),
            list(t._cached), dict(vars(t.stats)))


def _prompt(rng, base):
    """A prefix of ``base`` (any length: page-aligned or not) and a
    fresh tail of 0-5 tokens."""
    keep = int(rng.integers(1, len(base) + 1))
    tail = rng.integers(1000, 2000, int(rng.integers(0, 6)))
    return np.concatenate([base[:keep], tail]).astype(np.int32)


@pytest.mark.parametrize("n_shards,seed", [(1, 0), (1, 1), (2, 2), (2, 3)])
def test_prefix_index_lockstep_with_reference(n_shards, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1000, 6 * PAGE + 3).astype(np.int32)
    port, ref = _tables(32, n_shards)
    live, nxt, mid_page_prompts, mid_page_hits = [], 0, 0, 0
    for step in range(120):
        op = rng.random()
        if op < 0.5 or not live:
            if sum(port.pages_needed(port._lengths[s]) for s in live) > 20:
                seq = live.pop(int(rng.integers(len(live))))
                assert port.free_sequence(seq) == ref.free_sequence(seq)
                continue
            prompt = _prompt(rng, base)
            seq, nxt = nxt, nxt + 1
            for shard in range(n_shards):
                assert (port.prefix_tokens_on_shard(prompt, shard)
                        == ref.prefix_tokens_on_shard(prompt, shard))
            port.add_sequence(seq)
            ref.add_sequence(seq)
            assert port.probe_prefix(seq, prompt) == \
                ref.probe_prefix(seq, prompt)
            n = port.match_prefix(seq, prompt)
            assert n == ref.match_prefix(seq, prompt)
            mid_page_hits += bool(n % PAGE)
            s = int(prompt.shape[0])
            mid_page_prompts += bool(s % PAGE)
            for t in (port, ref):
                t.ensure_resident(seq, n_tokens=s)
                if n % PAGE:
                    t.make_writable(seq, n // PAGE)
                t.set_length(seq, s)
                t.register_prefix(seq, prompt)
            live.append(seq)
        elif op < 0.8:
            seq = live.pop(int(rng.integers(len(live))))
            assert port.free_sequence(seq) == ref.free_sequence(seq)
        elif n_shards > 1:
            pages = sorted(set(port._resident.values()) | set(port._cached))
            phys = pages[int(rng.integers(len(pages)))]
            dst = 1 - port.shard_of_phys(phys)
            if port.shard_free_pages(dst) > 0:
                assert port.migrate_page(phys, dst) == \
                    ref.migrate_page(phys, dst)
        assert _state(port) == _state(ref), step
    if n_shards > 1:
        for t in (port, ref):
            for seq in t.sequences_on_shard(1):
                t.free_sequence(seq)
            t.disable_shard(1)
        assert _state(port) == _state(ref)
        prompt = _prompt(rng, base)
        port.add_sequence(nxt)
        ref.add_sequence(nxt)
        assert port.match_prefix(nxt, prompt) == \
            ref.match_prefix(nxt, prompt)
    assert port.stats.prefix_hits > 0
    assert mid_page_prompts > 1 and mid_page_hits > 0


def test_mid_page_entry_is_matched_and_forgotten():
    """A prompt that ends mid-page is indexed by its tail; a later prompt
    extending it matches through that tail (a partial hit ends the
    chain), and not once the cache is cleared."""
    port, ref = _tables(16, 1)
    first = np.arange(2 * PAGE + 2, dtype=np.int32)
    longer = np.concatenate([first, [77, 78, 79]]).astype(np.int32)
    for t in (port, ref):
        t.add_sequence(0)
        t.ensure_resident(0, n_tokens=len(first))
        t.set_length(0, len(first))
        t.register_prefix(0, first)
    assert port.probe_prefix(1, longer) == ref.probe_prefix(1, longer) \
        == len(first)
    for t in (port, ref):
        t.free_sequence(0)
        t.clear_prefix_cache()
    assert port.probe_prefix(1, longer) == ref.probe_prefix(1, longer) == 0
