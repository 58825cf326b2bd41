"""The serving knobs of the port's PagedServer and PoolServer against the
JAX package's on the same converted weights and numpy prompts:
``prefix_cache=False`` (the cold baseline), the window sized by
``hbm_bytes`` / ``hbm_pages_per_layer``, a bf16 page store (``dtype``),
the pool's ``dtype`` and ``prefix_cache``; and the cell grid of
``configs.base``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core.kv_tier import PageStore as JStore  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.runtime.pool import PoolServer as JPool  # noqa: E402
from repro.runtime.serve import PagedServer as JServer  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core.kv_tier import PageStore  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime.pool import PoolServer  # noqa: E402
from repro_torch.runtime.serve import PagedServer  # noqa: E402

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def bf16_ulps(x, n=4):
    """``n`` bf16 ulps of the largest |x|.  A bf16 residual stream on
    both sides, whose products and elementwise chains the two packages
    round at different points (XLA keeps f32 inside a fusion, torch
    rounds after each operation): on these weights either bf16 server's
    logits lie 1-4.4 ulps from the f32 server's and 0.8-2.6 from each
    other, so they agree to a few bf16 ulps, not to 1e-3."""
    return n * 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(jbase.get_arch("granite_3_2b").reduced(),
                              n_layers=2, vocab_size=64)
    jmodel = jget_model(cfg, compute_dtype=jnp.float32, moe_no_drop=True)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(base.ArchConfig(**dataclasses.asdict(cfg)))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return cfg, (jmodel, jparams), (tmodel, tparams)


def _servers(models, dtype=jnp.float32, pool=False, **kw):
    _, (jm, jp), (tm, tp) = models
    if pool:
        return (JPool(jm, jp, n_nodes=1, dtype=dtype, **kw),
                PoolServer(tm, tp, n_nodes=1, dtype=DTYPES[dtype],
                           device="cpu", **kw))
    return (JServer(jm, jp, dtype=dtype, **kw),
            PagedServer(tm, tp, dtype=DTYPES[dtype], device="cpu", **kw))


def _shared_prefix_prompts(cfg, b=3, s=12, shared=8, seed=0):
    """``b`` prompts of ``s`` tokens whose first ``shared`` agree."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    p[:, :shared] = p[0, :shared]
    return p


def _admit(server, prompts, chunk=None):
    return [server.add_request(i, p, chunk=chunk)
            for i, p in enumerate(prompts)]


# ---------------------------------------------------------------------------
# prefix_cache


@pytest.mark.parametrize("pool", [False, True], ids=["paged", "pool"])
def test_prefix_cache_off_matches_reference(models, pool):
    """Cold: every admission computes every prompt token, nothing is
    matched or registered, and the tokens are the reference's (and the
    warm run's)."""
    cfg = models[0]
    prompts = _shared_prefix_prompts(cfg)
    size = {"hbm_pages_per_node" if pool else "hbm_pages": 16}
    js, ts = _servers(models, pool=pool, page_size=4, prefix_cache=False,
                      **size)
    assert ts.prefix_cache is False
    assert ts.begin_request(0, prompts[0]) == \
        js.begin_request(0, prompts[0]) == 0
    for srv in (js, ts):
        srv.free_sequence(0)
    _admit(js, prompts, chunk=4)
    _admit(ts, prompts, chunk=4)
    assert ts.prefill_tokens_computed == js.prefill_tokens_computed == \
        prompts.size
    assert ts.table.stats.prefix_hits == 0 and ts.prefix_hit_rate() == 0.0
    assert not ts.table._prefix_index[0]
    cold = ts.decode(5, horizon=4)
    assert cold == js.decode(5, horizon=4)
    assert ts.tier_stats() == js.tier_stats()

    jw, tw = _servers(models, pool=pool, page_size=4, **size)
    _admit(jw, prompts, chunk=4)
    _admit(tw, prompts, chunk=4)
    assert tw.prefill_tokens_computed == jw.prefill_tokens_computed < \
        prompts.size
    assert tw.decode(5, horizon=4) == cold


def test_pool_prefix_cache_off_four_nodes(models):
    """A 4-node pool with the cache off: every prompt token computed,
    the tokens those of the 1-node pool."""
    cfg, _, (tm, tp) = models
    prompts = _shared_prefix_prompts(cfg, b=4)
    out = {}
    for n in (1, 4):
        srv = PoolServer(tm, tp, n_nodes=n, page_size=4,
                         hbm_pages_per_node=16, prefix_cache=False,
                         device="cpu")
        _admit(srv, prompts, chunk=4)
        assert srv.prefill_tokens_computed == prompts.size
        out[n] = srv.decode(4, horizon=2)
    assert out[4] == out[1]


# ---------------------------------------------------------------------------
# window sizing


@pytest.mark.parametrize("dtype,page_dtype", [
    (jnp.float32, "fp32"), (jnp.bfloat16, "fp32"), (jnp.float32, "int8"),
    (jnp.float32, "fp8"), (jnp.bfloat16, "int8")])
def test_hbm_bytes_page_counts_match_reference(models, dtype, page_dtype):
    cfg = models[0]
    kw = dict(n_layers=cfg.n_layers, page_size=4, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.hd, page_dtype=page_dtype)
    pb = PageStore.stacked_page_bytes(dtype=DTYPES[dtype], **kw)
    assert pb == JStore.stacked_page_bytes(dtype=dtype, **kw)
    for budget in (1, pb - 1, pb, 7 * pb + 3, 40 * pb):
        js, ts = _servers(models, dtype, page_size=4, hbm_bytes=budget,
                          page_dtype=page_dtype)
        assert ts.hbm_pages == js.hbm_pages == max(1, budget // pb)
        assert ts.store.page_bytes() == js.store.page_bytes() == pb
        assert ts.store.format_key == js.store.format_key
    # per node, the pool's budget
    js, ts = _servers(models, dtype, pool=True, page_size=4,
                      hbm_bytes_per_node=9 * pb + 1, page_dtype=page_dtype)
    assert ts.pages_per_node == js.pages_per_node == 9


def test_hbm_pages_defaults_match_reference(models):
    for kw in ({}, {"hbm_pages_per_layer": 24}, {"hbm_pages": 12},
               {"hbm_pages": 12, "hbm_pages_per_layer": 24},
               {"hbm_pages": 12, "hbm_bytes": 10 ** 6}):
        js, ts = _servers(models, page_size=4, **kw)
        assert ts.hbm_pages == js.hbm_pages, kw
        assert ts.store.k_pages.shape[1] == ts.hbm_pages


def test_hbm_bytes_window_serves_like_reference(models):
    """An int8 window sized by bytes spills like the reference's."""
    cfg = models[0]
    pb = PageStore.stacked_page_bytes(
        n_layers=cfg.n_layers, page_size=4, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, page_dtype="int8")
    js, ts = _servers(models, page_size=4, hbm_bytes=9 * pb,
                      page_dtype="int8")
    prompts = _shared_prefix_prompts(cfg, b=4, s=10, shared=0, seed=3)
    _admit(js, prompts)
    _admit(ts, prompts)
    assert ts.tier_stats()["page_outs"] > 0
    # the working set of a step (8 pages pinned) fits the 9-page window
    assert ts.decode(6, seqs=[2, 3]) == js.decode(6, seqs=[2, 3])
    assert ts.tier_stats() == js.tier_stats()


# ---------------------------------------------------------------------------
# a bf16 page store


def _agree_to_bf16(got, want, what):
    """Logits within four bf16 ulps of the largest; where the argmax
    differs, the reference's two best are within twice that distance (a
    near-tie).  got/want: [B, V] or [V]."""
    got = np.atleast_2d(np.asarray(got, np.float32))
    want = np.atleast_2d(np.asarray(want, np.float32))
    tol = bf16_ulps(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)
    for g, w in zip(got, want):
        if g.argmax() != w.argmax():
            top2 = np.sort(w)[-2:]
            assert top2[1] - top2[0] <= 2 * tol, (what, top2)


@pytest.mark.parametrize("page_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("pool", [False, True], ids=["paged", "pool"])
def test_bf16_store_matches_reference(models, page_dtype, pool):
    """dtype=bf16: the store holds bf16 pages (or int8 codes) and the
    steps compute in bf16 on both sides.  Admission and every decode
    step, fed the reference's tokens, give logits within four bf16 ulps
    of the largest and the same argmax but at a near-tie; the tier
    counters are the reference's."""
    cfg = models[0]
    size = ({"hbm_pages_per_node": 32} if pool else {"hbm_pages": 32})
    js, ts = _servers(models, jnp.bfloat16, pool=pool, page_size=4,
                      page_dtype=page_dtype, **size)
    assert ts.store.format_key == js.store.format_key
    if page_dtype == "fp32":
        assert ts.store.k_pages.dtype == torch.bfloat16
    prompts = _shared_prefix_prompts(cfg, seed=2)
    for i, p in enumerate(prompts):
        _agree_to_bf16(ts.add_request(i, p).float(), js.add_request(i, p),
                       f"admission {i}")
    tokens = js.pending_tokens()
    for step in range(6):
        jseqs, want = js.step_batch(tokens)
        tseqs, got = ts.step_batch(tokens)
        assert tseqs == jseqs
        _agree_to_bf16(got.float(), want, f"step {step}")
        tokens = dict(zip(jseqs, np.asarray(want).argmax(-1).tolist()))
    assert ts.tier_stats() == js.tier_stats()


def test_bf16_step_against_plain_attention(models):
    """The bf16 store's kernel path (the wrappers' CPU versions) against
    the eager step_reference: the same function, bit for bit."""
    cfg = models[0]
    _, ts = _servers(models, jnp.bfloat16, page_size=4, hbm_pages=32)
    _admit(ts, _shared_prefix_prompts(cfg, seed=4))
    pending = ts.pending_tokens()
    want = ts.step_reference(pending)
    _, got = ts.step_batch(pending)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the cell grid


@pytest.mark.parametrize("runnable_only", [True, False])
def test_cells_match_reference(runnable_only):
    got = [(a.name, s.name, st) for a, s, st in base.cells(runnable_only)]
    want = [(a.name, s.name, st) for a, s, st in jbase.cells(runnable_only)]
    assert got == want
    assert [a.name for a in base.all_archs()] == \
        [a.name for a in jbase.all_archs()]
    for a, s, st in base.cells(False):
        assert base.cell_status(a, s) == st
