"""The port's PagedServer (CPU) against the JAX package's PagedServer on
the same converted weights and numpy prompts: admission logits, greedy
tokens on every decode path, chunked prefill, the prefix cache,
eviction telemetry and quantized pages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.core.kv_tier import PageStore as JStore  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.runtime.serve import PagedServer as JServer  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core.kv_tier import PageStore  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime.serve import PagedServer  # noqa: E402

# f32 on both sides, two layers; only summation orders differ
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(jget_arch("granite_3_2b").reduced(),
                              n_layers=2, vocab_size=64)
    jmodel = jget_model(cfg, compute_dtype=jnp.float32, moe_no_drop=True)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(ArchConfig(**dataclasses.asdict(cfg)))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return cfg, (jmodel, jparams), (tmodel, tparams)


def _servers(models, **kw):
    _, (jm, jp), (tm, tp) = models
    return (JServer(jm, jp, dtype=jnp.float32, **kw),
            PagedServer(tm, tp, device="cpu", **kw))


def _prompts(cfg, b=3, s=7, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)


def test_add_request_logits_and_format_key(models):
    cfg = models[0]
    js, ts = _servers(models, page_size=4, hbm_pages=32)
    assert ts.store.format_key == js.store.format_key == \
        "kvpage:v2:fp32:float32"
    for i, p in enumerate(_prompts(cfg)):
        want = np.asarray(js.add_request(i, p))
        got = ts.add_request(i, p).numpy()
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert ts.pending_tokens() == js.pending_tokens()


@pytest.mark.parametrize("horizon", [None, 1, 4])
def test_greedy_tokens_match_jax(models, horizon):
    cfg = models[0]
    js, ts = _servers(models, page_size=4, hbm_pages=32)
    for i, p in enumerate(_prompts(cfg)):
        js.add_request(i, p)
        ts.add_request(i, p)
    want = js.decode(6, horizon=horizon)
    got = ts.decode(6, horizon=horizon)
    assert got == want
    assert ts.tier_stats() == js.tier_stats()


def test_budgets_and_eos_match_jax(models):
    cfg = models[0]
    js, ts = _servers(models, page_size=4, hbm_pages=32)
    for i, p in enumerate(_prompts(cfg, seed=5)):
        js.add_request(i, p)
        ts.add_request(i, p)
    free = js.decode(4, horizon=4)              # find a token to stop on
    js2, ts2 = _servers(models, page_size=4, hbm_pages=32)
    for i, p in enumerate(_prompts(cfg, seed=5)):
        js2.add_request(i, p)
        ts2.add_request(i, p)
    kw = dict(horizon=4, eos_id=free[0][1], budgets={0: 7, 1: 2, 2: 5})
    assert ts2.decode(7, **kw) == js2.decode(7, **kw)
    assert ts2.tier_stats() == js2.tier_stats()


def test_chunked_prefill_matches_one_shot(models):
    cfg = models[0]
    _, (tm, tp) = models[1], models[2]
    prompt = _prompts(cfg, b=1, s=13, seed=1)[0]
    one = PagedServer(tm, tp, page_size=4, hbm_pages=16, device="cpu")
    chunked = PagedServer(tm, tp, page_size=4, hbm_pages=16, device="cpu")
    js = _servers(models, page_size=4, hbm_pages=16)[0]
    want = one.add_request(0, prompt)
    got = chunked.add_request(0, prompt, chunk=3)
    jwant = np.asarray(js.add_request(0, prompt, chunk=3))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    np.testing.assert_allclose(got.numpy(), jwant, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert chunked.decode(4, horizon=2) == one.decode(4, horizon=2)


def test_shared_prefix_hits_match_jax(models):
    cfg = models[0]
    js, ts = _servers(models, page_size=4, hbm_pages=32)
    base = _prompts(cfg, b=1, s=14, seed=2)[0]
    other = base.copy()
    other[10:] = (other[10:] + 1) % cfg.vocab_size   # shares 10 tokens
    for server in (js, ts):
        server.add_request(0, base, chunk=5)
        server.add_request(1, other, chunk=5)
    assert ts.table.stats.prefix_hits == js.table.stats.prefix_hits > 0
    assert ts.prefix_hit_rate() == js.prefix_hit_rate()
    assert ts.decode(5, horizon=4) == js.decode(5, horizon=4)
    assert ts.tier_stats() == js.tier_stats()


def test_eviction_tier_stats_match_jax(models):
    cfg = models[0]
    js, ts = _servers(models, page_size=4, hbm_pages=4)
    prompts = _prompts(cfg, b=2, s=7, seed=3)
    for server in (js, ts):
        for i, p in enumerate(prompts):
            server.add_request(i, p)
    got = [ts.decode(4, seqs=[1]), ts.decode(4, seqs=[0], horizon=2)]
    want = [js.decode(4, seqs=[1]), js.decode(4, seqs=[0], horizon=2)]
    assert got == want
    stats = ts.tier_stats()
    assert stats == js.tier_stats()
    assert stats["page_outs"] > 0 and stats["page_ins"] > 0


@pytest.mark.parametrize("page_dtype", ["int8", "fp8"])
def test_quantized_pages_match_jax(models, page_dtype):
    cfg = models[0]
    js, ts = _servers(models, page_size=4, hbm_pages=32,
                      page_dtype=page_dtype)
    assert ts.store.format_key == js.store.format_key
    for i, p in enumerate(_prompts(cfg, seed=4)):
        js.add_request(i, p, chunk=4)
        ts.add_request(i, p, chunk=4)
    # K projections agree to f32 rounding, so a code may sit one
    # quantization step away where a value lands on a rounding boundary
    got_k = ts.store.k_pages.float() * ts.store.k_scale[..., None]
    want_k = (np.asarray(js.store.k_pages.astype(jnp.float32)) *
              np.asarray(js.store.k_scale)[..., None])
    step = np.asarray(js.store.k_scale)[..., None] * (
        1.0 if page_dtype == "int8" else 32.0)
    assert np.all(np.abs(got_k.numpy() - want_k) <= step + 1e-6)
    assert ts.decode(5, horizon=4) == js.decode(5, horizon=4)
    assert ts.tier_stats() == js.tier_stats()


@pytest.mark.parametrize("page_dtype", ["fp32", "int8"])
def test_step_batch_matches_step_reference(models, page_dtype):
    cfg, _, (tm, tp) = models
    ts = PagedServer(tm, tp, page_size=4, hbm_pages=32, device="cpu",
                     page_dtype=page_dtype)
    for i, p in enumerate(_prompts(cfg, seed=6)):
        ts.add_request(i, p)
    before = {n: t.clone() for n, t in ts.store.device_state().items()}
    ref = ts.step_reference(ts.pending_tokens())
    for n, t in ts.store.device_state().items():        # reference: no write
        assert torch.equal(t, before[n]), n
    _, got = ts.step_batch(ts.pending_tokens())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_not_yet_ported_options_raise(models):
    """Sharded serving over a mesh is ported (tests/test_torch_mesh.py),
    as are sampling and speculative decoding
    (tests/test_torch_speculative.py); a mesh that is not a
    ``DeviceMesh`` is refused."""
    from repro_torch.runtime.serve import make_serving_fns
    _, _, (tm, _) = models
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_serving_fns(tm, mesh=object())


@pytest.mark.parametrize("page_dtype", ["fp32", "int8", "fp8"])
def test_page_store_matches_jax(page_dtype):
    """Token writes (quantized at write time), the host-tier round trip,
    the CoW copy and adopt, against the JAX store."""
    kw = dict(n_layers=2, page_size=4, hbm_pages=6, n_kv_heads=2,
              head_dim=8, page_dtype=page_dtype)
    js = JStore(dtype=jnp.float32, **kw)
    ts = PageStore(device="cpu", **kw)
    assert ts.page_bytes() == js.page_bytes()
    assert ts.format_key == js.format_key
    rng = np.random.default_rng(7)
    for li, phys, off in [(0, 1, 0), (1, 1, 3), (0, 4, 2)]:
        k, v = rng.standard_normal((2, 2, 8)).astype(np.float32) * 3
        js.write_token(li, phys, off, jnp.asarray(k), jnp.asarray(v))
        ts.write_token(li, phys, off, torch.from_numpy(k),
                       torch.from_numpy(v))

    def as_f32(store, jax_side):
        if jax_side:
            kk = np.asarray(store.k_pages.astype(jnp.float32))
            sc = (np.asarray(store.k_scale)[..., None] if store.quantized
                  else 1.0)
        else:
            kk = store.k_pages.float().numpy()
            sc = store.k_scale[..., None].numpy() if store.quantized else 1.0
        return kk * sc

    np.testing.assert_allclose(as_f32(ts, False), as_f32(js, True),
                               atol=1e-6, rtol=1e-6)
    host = ts.read_page(1)                    # spill, clobber, restore
    ts.copy_page(4, 1)
    assert torch.equal(ts.k_pages[:, 1], ts.k_pages[:, 4])
    ts.write_page(1, *host)
    js.copy_page(4, 5)
    ts.copy_page(4, 5)
    np.testing.assert_allclose(as_f32(ts, False), as_f32(js, True),
                               atol=1e-6, rtol=1e-6)
    state = {n: t.clone() for n, t in ts.device_state().items()}
    ts.write_token(0, 2, 1, torch.ones(2, 8), torch.ones(2, 8))
    ts.adopt(state)                           # a copied state is installed
    assert all(torch.equal(t, state[n])
               for n, t in ts.device_state().items())
