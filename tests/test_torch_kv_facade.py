"""The port's single-layer facade ``PagedKVCache`` and ``PageStore.layer``
(CPU) against the JAX package's: the property test of
``tests/test_property.py`` on the port, a lockstep run of both facades
(tables, lengths, stats and residency after the same appends, prefix
shares and evictions; the gathered views equal), views that are
snapshots, and ``kernel_view`` through the port's ``ops.paged_attention``
against the reference's ``ops.paged_attention`` (interpret mode)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
hypothesis = pytest.importorskip("hypothesis")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import PagedKVCache as JCache  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import PagedKVCache  # noqa: E402
from repro_torch.core.kv_tier import PageStore  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the reference's property test, on the port's facade


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(2, 3), st.integers(4, 24))
def test_kv_tier_consistency(seed, n_seqs, n_tokens):
    """Interleaved appends under eviction pressure; per-seq kernel views
    (pinned) must always reconstruct the dense reference."""
    rng = np.random.default_rng(seed)
    hkv, hd, page = 2, 8, 4
    pages_per_seq = -(-n_tokens // page)
    # window holds one sequence's view (+1) but not all sequences -> spill
    hbm_pages = pages_per_seq + 1
    cache = PagedKVCache(page_size=page, hbm_pages=hbm_pages,
                         n_kv_heads=hkv, head_dim=hd, dtype=torch.float32,
                         device="cpu")
    dense = {s: [] for s in range(n_seqs)}
    for s in range(n_seqs):
        cache.add_sequence(s)
    for t in range(n_tokens):
        for s in range(n_seqs):
            k = rng.normal(size=(hkv, hd)).astype(np.float32)
            v = rng.normal(size=(hkv, hd)).astype(np.float32)
            cache.append_token(s, torch.from_numpy(k), torch.from_numpy(v))
            dense[s].append(k)
    for s in range(n_seqs):
        kp, vp, pt, lens = cache.kernel_view([s])
        assert int(lens[0]) == n_tokens
        got = kp[pt[0].long()].reshape(-1, hkv, hd)[:n_tokens].numpy()
        np.testing.assert_allclose(got, np.stack(dense[s]), atol=1e-6)
    if n_seqs * pages_per_seq > hbm_pages:
        assert cache.stats.page_outs > 0      # spill path exercised
    assert cache.residency() <= 1.0


# ---------------------------------------------------------------------------
# lockstep against the reference's facade


def _state(cache):
    t = cache.table
    return (dict(t._resident), dict(t._lengths), dict(vars(t.stats)),
            cache.residency(), sorted(t._host), dict(t._rc))


def _drive(caches, rng, n_seqs=5, n_tokens=22, hkv=2, hd=16, shared=10):
    """The same appends on every cache: sequence 1 maps ``shared`` - 1
    tokens of sequence 0's registered prefix through the table (ending
    mid-page: a copy-on-write split at its first append), the rest
    append alone, round-robin, under eviction pressure; views of pairs
    taken along the way."""
    prefix = rng.integers(0, 1000, shared + 1).astype(np.int32)
    for c in caches:
        c.add_sequence(0)
    for t in range(shared):
        k, v = (rng.normal(size=(hkv, hd)).astype(np.float32)
                for _ in range(2))
        for c in caches:
            c.append_token(0, _tok(c, k), _tok(c, v))
    for c in caches:
        c.table.register_prefix(0, prefix[:shared])
        for s in range(1, n_seqs):
            c.add_sequence(s)
        assert c.table.match_prefix(1, prefix[:shared]) == shared - 1
    yield "prefix"
    for t in range(n_tokens):
        for s in range(n_seqs):
            if s == 0 and t >= n_tokens - 3:
                continue
            k, v = (rng.normal(size=(hkv, hd)).astype(np.float32)
                    for _ in range(2))
            for c in caches:
                c.append_token(s, _tok(c, k), _tok(c, v))
        if t % 5 == 4:
            seqs = [t % n_seqs, (t + 1) % n_seqs]
            for c in caches:
                c.kernel_view(seqs)
            yield "view"
        if t == 12:
            for c in caches:
                c.prefetch(2)
                c.ensure_resident(3, pin=True)
                c.unpin_all()
        yield "append"
    for c in caches:
        assert c.free_sequence(4) == c.table.pages_needed(n_tokens)
    yield "free"


def _tok(cache, x):
    if isinstance(cache, PagedKVCache):
        return torch.from_numpy(x)
    return jnp.asarray(x)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lockstep_with_reference(dtype):
    tdt, jdt = DTYPES[dtype]
    kw = dict(page_size=4, hbm_pages=14, n_kv_heads=2, head_dim=16)
    port = PagedKVCache(**kw, dtype=tdt, device="cpu")
    ref = JCache(**kw, dtype=jdt)
    assert port.store.format_key == ref.store.format_key
    rng = np.random.default_rng(0)
    gen = _drive([port, ref], rng)
    for _ in gen:
        assert _state(port) == _state(ref)
        assert {s: port.length(s) for s in port.table._lengths} == \
            {s: ref.length(s) for s in ref.table._lengths}
    stats = port.stats
    assert stats.page_outs > 0 and stats.page_ins > 0
    assert stats.cow_splits == 1 and stats.prefix_hits == 3
    assert stats.prefix_tokens == 9
    # views after the run: the same table and lengths, the same pages
    # gathered through it
    for seqs in ([0, 1], [2, 3], [1, 3]):
        tv, jv = port.kernel_view(seqs), ref.kernel_view(seqs)
        np.testing.assert_array_equal(tv[2].numpy(), np.asarray(jv[2]))
        np.testing.assert_array_equal(tv[3].numpy(), np.asarray(jv[3]))
        for tp, jp in zip(tv[:2], jv[:2]):
            got = _as_np(tp)[tv[2].numpy()]
            want = _as_np(jp)[np.asarray(jv[2])]
            for b, n in enumerate(tv[3].tolist()):
                np.testing.assert_array_equal(
                    got[b].reshape(-1, 2, 16)[:n],
                    want[b].reshape(-1, 2, 16)[:n])
        assert _state(port) == _state(ref)


def test_views_are_snapshots():
    """A view keeps its values when later appends, evictions and
    page-ins rewrite the window; ``PageStore.layer`` copies."""
    rng = np.random.default_rng(1)
    cache = PagedKVCache(page_size=4, hbm_pages=6, n_kv_heads=2,
                         head_dim=8, device="cpu")
    for s in range(3):
        cache.add_sequence(s)
        for _ in range(8):
            cache.append_token(s, *(torch.from_numpy(rng.normal(
                size=(2, 8)).astype(np.float32)) for _ in range(2)))
    view = cache.kernel_view([0])
    kept = [t.clone() for t in view]
    live_k = cache.store.k_pages[0]
    assert view[0].data_ptr() != live_k.data_ptr()
    for s in (1, 2, 0, 1):              # page-ins and evictions
        cache.kernel_view([s])
        cache.append_token(s, *(torch.from_numpy(rng.normal(
            size=(2, 8)).astype(np.float32)) for _ in range(2)))
    assert cache.stats.page_outs > 0
    assert not torch.equal(cache.store.k_pages[0], kept[0])
    for a, b in zip(view, kept):
        assert torch.equal(a, b)
    store = PageStore(n_layers=2, page_size=4, hbm_pages=3, n_kv_heads=1,
                      head_dim=8, device="cpu")
    k, v = store.layer(1)
    store.k_pages.fill_(1.0)
    assert not k.any() and not v.any()
    assert k.shape == (3, 4, 1, 8) and k.is_contiguous()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_view_attention_matches_reference(dtype):
    """``kernel_view`` fed to the port's ``ops.paged_attention`` (its
    plain version on the CPU) against the reference's view through its
    ``ops.paged_attention`` (Pallas, interpret mode): within 1e-5."""
    tdt, jdt = DTYPES[dtype]
    kw = dict(page_size=4, hbm_pages=16, n_kv_heads=2, head_dim=16)
    port = PagedKVCache(**kw, dtype=tdt, device="cpu")
    ref = JCache(**kw, dtype=jdt)
    rng = np.random.default_rng(2)
    for s in range(4):
        for c in (port, ref):
            c.add_sequence(s)
        for _ in range(5 + 3 * s):
            k, v = (rng.normal(size=(2, 16)).astype(np.float32)
                    for _ in range(2))
            port.append_token(s, torch.from_numpy(k), torch.from_numpy(v))
            ref.append_token(s, jnp.asarray(k), jnp.asarray(v))
    q = rng.normal(size=(4, 8, 16)).astype(np.float32)
    got = ops.paged_attention(torch.from_numpy(q), *port.kernel_view(
        [0, 1, 2, 3]))
    want = jops.paged_attention(jnp.asarray(q), *ref.kernel_view(
        [0, 1, 2, 3]), interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
