"""Pool serving on the port (CPU) against the JAX package on the same
numpy inputs and converted weights.

The partial contract: ``paged_attention_partial`` and the pool form's
plain version (``ref.paged_pool_partials_ref``, f32 / int8 / fp8;
placed and striped ownership) against the reference's
``paged_attention_partial`` per node, the node-axis merge against the
reference's ``combine_partials`` under ``jax.vmap`` with an axis name,
and the pool-form wrappers (one node bit-equal to ``paged_attention``,
the split emulation).  Then ``PoolServer``: one node bit-equal to the
port's ``PagedServer``; four nodes within 1e-4 of the reference's
one-node ``PagedServer`` with the same greedy tokens and the reference's
placements; ``fail_node`` / ``drain_node`` reports and per-node stats;
``PoolRouter`` failover, the striped fail-fast and requeue shedding;
the ``node_headroom`` the offload planner reads; and ``preferred_node``.
The reference's multi-node side needs forced host devices: it runs once,
in one subprocess, and prints what the port is held to.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import kv_tier as tkv  # noqa: E402
from repro_torch.core.storage_pool import StoragePool  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.runtime.offload import OffloadPlanner  # noqa: E402
from repro_torch.runtime.pool import PoolServer, mesh_bucket  # noqa: E402
from repro_torch.runtime.retrieval import RetrievalFrontend  # noqa: E402
from repro_torch.runtime.scheduler import PoolRouter, Request  # noqa: E402
from repro_torch.runtime.serve import (PagedServer,  # noqa: E402
                                       SamplingConfig)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ["f32", "int8", "fp8"]
# f32 on both sides; only the summation order (and, for codes, where the
# scale multiplies) differs
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several test processes
    on the host's cores, and torch's per-process thread pools
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the partial contract
# ---------------------------------------------------------------------------

N_NODES, N_LOCAL, H, HKV, D, PAGE, PPS = 4, 6, 8, 2, 16, 4, 6
# a padding row, short rows, a partial last page, a full table
LENGTHS = [0, 1, 5, 13, 24, 19]


def _inputs(seed, policy):
    """q, pages and a global table whose rows own pages by ``policy``:
    placed (every page of row i in node i % N's window) or striped
    (logical page j in node j % N's window)."""
    rng = np.random.default_rng(seed)
    b = len(LENGTHS)
    n_phys = N_NODES * N_LOCAL
    q = rng.standard_normal((b, H, D)).astype(np.float32)
    k = rng.standard_normal((n_phys, PAGE, HKV, D)).astype(np.float32)
    v = rng.standard_normal((n_phys, PAGE, HKV, D)).astype(np.float32)
    table = np.zeros((b, PPS), np.int32)
    for i, n in enumerate(LENGTHS):
        for j in range(-(-n // PAGE)):
            node = i % N_NODES if policy == "placed" else j % N_NODES
            table[i, j] = node * N_LOCAL + rng.integers(N_LOCAL)
    return q, k, v, table, np.asarray(LENGTHS, np.int32)


def _pages(k, v, dtype):
    """(torch k, v, k_scale, v_scale) and their JAX twins; codes cross to
    JAX as bytes, reinterpreted on its side."""
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if dtype == "f32":
        return (kt, vt, None, None), (jnp.asarray(k), jnp.asarray(v), None,
                                      None)
    code, qmax = tkv._CODE[dtype]
    kq, ks = tkv.quantize_page_kv(kt, qmax, code)
    vq, vs = tkv.quantize_page_kv(vt, qmax, code)
    jcode = jnp.int8 if dtype == "int8" else jnp.float8_e4m3fn

    def j(x):
        return jax.lax.bitcast_convert_type(
            jnp.asarray(x.view(torch.uint8).numpy()), jcode)
    return ((kq, vq, ks, vs),
            (j(kq), j(vq), jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy())))


def _node_slice(x, s):
    return None if x is None else x[s * N_LOCAL:(s + 1) * N_LOCAL]


@pytest.mark.parametrize("policy", ["placed", "striped"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_partials_match_reference(dtype, policy):
    """Per node: the port's ``paged_attention_partial`` over the node's
    local pages and ``ref.paged_pool_partials_ref`` over the global
    store both equal the reference's ``paged_attention_partial``."""
    q, k, v, table, lengths = _inputs(0, policy)
    (kt, vt, kst, vst), (kj, vj, ksj, vsj) = _pages(k, v, dtype)
    qt, tt, lt = (torch.from_numpy(x) for x in (q, table, lengths))
    pool_acc, pool_m, pool_l = tref.paged_pool_partials_ref(
        qt, kt, vt, tt, lt, N_NODES, N_LOCAL, kst, vst)
    for s in range(N_NODES):
        local = table - s * N_LOCAL
        owned = (local >= 0) & (local < N_LOCAL)
        want = jserve.paged_attention_partial(
            jnp.asarray(q), _node_slice(kj, s), _node_slice(vj, s),
            jnp.asarray(local), jnp.asarray(owned), jnp.asarray(lengths),
            k_scale=_node_slice(ksj, s), v_scale=_node_slice(vsj, s))
        got = tserve.paged_attention_partial(
            qt, _node_slice(kt, s), _node_slice(vt, s),
            torch.from_numpy(local), torch.from_numpy(owned), lt,
            _node_slice(kst, s), _node_slice(vst, s))
        for g, p, w in zip(got, (pool_acc[s], pool_m[s], pool_l[s]), want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                       atol=TOL)
            np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=TOL,
                                       atol=TOL)


@pytest.mark.parametrize("policy", ["placed", "striped"])
def test_combine_partials_matches_reference(policy):
    """The node-axis merge against the reference's collective merge
    (``pmax`` + ``psum`` under ``jax.vmap`` with an axis name, one CPU
    device); the padding row merges to exactly 0, never NaN."""
    q, k, v, table, lengths = _inputs(1, policy)
    acc, m, l = tref.paged_pool_partials_ref(
        *(torch.from_numpy(x) for x in (q, k, v, table, lengths)), N_NODES,
        N_LOCAL)
    got = tserve.combine_partials(acc, m, l)
    want = jax.vmap(lambda a, mm, ll: jserve.combine_partials(a, mm, ll, "n"),
                    axis_name="n")(jnp.asarray(acc.numpy()),
                                   jnp.asarray(m.numpy()),
                                   jnp.asarray(l.numpy()))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert torch.isfinite(got).all() and not got[0].any()
    # a node that owns nothing of a row is the identity (0, -1e30, 0)
    empty = ~torch.from_numpy(np.stack(
        [((table >= s * N_LOCAL) & (table < (s + 1) * N_LOCAL)).any(1)
         for s in range(N_NODES)]))
    assert (m[empty] == tserve.NEG_INF).all() and not l[empty].any()
    assert not acc[empty].any()
    # normalize_partials closes the whole store's single partial
    one = tref.paged_partials_ref(*(torch.from_numpy(x) for x in (
        q, k, v, table, lengths)), None, None)
    np.testing.assert_allclose(
        tserve.normalize_partials(*one).numpy(), got.numpy(), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pool_form_wrappers(dtype):
    """The pool-form wrappers on the CPU: at one node whose window is the
    store, ``paged_attention(_q8)``'s bits through both forms' tables; at
    four nodes the same function within 1e-5; the split emulation merged
    per node equals the per-node partials."""
    q, k, v, table, lengths = _inputs(2, "striped")
    (kt, vt, kst, vst), _ = _pages(k, v, dtype)
    qt, tt, lt = (torch.from_numpy(x) for x in (q, table, lengths))
    row = tt[4][None].expand(len(LENGTHS), PPS)       # the chunk form's table
    scales = () if dtype == "f32" else (kst, vst)
    single = tops.paged_attention_q8 if scales else tops.paged_attention
    pool = (tops.paged_attention_pool_q8 if scales
            else tops.paged_attention_pool)
    for tab in (tt, row):
        one = single(qt, kt, vt, *scales, tab, lt)
        assert torch.equal(pool(qt, kt, vt, *scales, tab, lt, n_nodes=1,
                                n_local=N_NODES * N_LOCAL), one)
        np.testing.assert_allclose(
            pool(qt, kt, vt, *scales, tab, lt, n_nodes=N_NODES,
                 n_local=N_LOCAL).numpy(), one.numpy(), rtol=TOL, atol=TOL)
    acc, m, l = tpa.pool_partials(qt, kt, vt, tt, lt, kst, vst,
                                  n_nodes=N_NODES, n_local=N_LOCAL,
                                  pages_per_split=2)
    assert acc.shape == (len(LENGTHS), H, N_NODES, 3, D)
    want = tref.paged_pool_partials_ref(qt, kt, vt, tt, lt, N_NODES, N_LOCAL,
                                        kst, vst)
    for g, w in zip(tref.merge_split_partials(acc, m, l), want):
        np.testing.assert_allclose(g.numpy(), torch.movedim(w, 0, 2).numpy(),
                                   rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="do not tile"):
        pool(qt, kt, vt, *scales, tt, lt, n_nodes=N_NODES, n_local=5)


# ---------------------------------------------------------------------------
# PoolServer, PoolRouter and the frontend against the JAX package
# ---------------------------------------------------------------------------

GENS = [4, 6, 3, 5, 4]

_REFERENCE = """
    import dataclasses, json
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import get_arch
    from repro.core.storage_pool import StoragePool
    from repro.models.api import get_model
    from repro.runtime.pool import PoolServer
    from repro.runtime.retrieval import RetrievalFrontend
    from repro.runtime.scheduler import PoolRouter, Request
    from repro.runtime.serve import SamplingConfig

    cfg = dataclasses.replace(get_arch("granite_3_2b").reduced(),
                              n_layers=2, vocab_size=64)
    model = get_model(cfg, compute_dtype=jnp.float32, moe_no_drop=True)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 6, dtype=np.int32)
               for _ in range(5)]
    gens = %(gens)r
    F32 = jnp.float32
    res = {}

    for policy in ("placed", "striped"):
        srv = PoolServer(model, params, n_nodes=4, page_size=4,
                         hbm_pages_per_node=8, dtype=F32, policy=policy)
        for i, p in enumerate(prompts):
            srv.add_request(i, p)
        res[policy] = {"node_of": [srv.node_of(i) for i in range(5)],
                       "decode": srv.decode(max(gens)),
                       "free": srv.node_free_pages()}
        if policy == "placed":
            victim = srv.node_of(0)
            res["fail"] = {"victims": srv.fail_node(victim),
                           "alive": srv.alive_nodes(),
                           "free": srv.node_free_pages()}

    srv = PoolServer(model, params, n_nodes=4, page_size=4,
                     hbm_pages_per_node=8, dtype=F32)
    for i, p in enumerate(prompts):
        srv.add_request(i, p)
    srv.decode(2)
    rep = srv.drain_node(srv.node_of(0))
    res["drain"] = dict(rep, after=srv.decode(3),
                        node_of=[srv.node_of(i) for i in range(5)],
                        parked=srv.parked_nodes(),
                        nodes=srv.node_tier_stats(),
                        tier=srv.tier_stats())

    def router_run(max_requeues=3, kill_after=2, **kw):
        srv = PoolServer(model, params, n_nodes=4, page_size=4,
                         hbm_pages_per_node=8, dtype=F32)
        pool = StoragePool(4, heartbeat_timeout=0.0)
        pool.attach_server(srv)
        router = PoolRouter(srv, pool, max_active=5,
                            max_requeues=max_requeues, **kw)
        for i, (p, g) in enumerate(zip(prompts, gens)):
            router.submit(Request(rid=i, prompt=p, max_tokens=g))
        for _ in range(kill_after):
            router.step()
        head = router.node_headroom()
        rid = min(router.active)
        victim = srv.node_of(rid)
        pool.nodes[pool.serving_ips()[victim]].fail()
        stats = router.run_to_completion()
        return {"out": {r.rid: r.output for r in router.finished},
                "rejected": sorted(r.rid for r in router.rejected),
                "requeues": router.requeues, "victim": victim,
                "headroom": head, "frames": pool.driver.stats.control_frames,
                "events": [e[0] for e in pool.events],
                "tier": stats["tier"]}

    res["failover"] = router_run()
    res["shed"] = router_run(
        max_requeues=0, kill_after=1, horizon=4,
        sampling=SamplingConfig(temperature=0.8, top_p=0.9, seed=11))

    srv = PoolServer(model, params, n_nodes=2, page_size=4,
                     hbm_pages_per_node=4, dtype=F32)
    pool = StoragePool(2)
    pool.attach_server(srv)
    for i, p in enumerate(prompts[:4]):
        srv.add_request(i, p, node=pool.place_sequence(i, 6 + 4))
    for i in range(4):
        srv.decode(3, seqs=[i])
    res["spill"] = {"served": pool.serving_tier_stats()}

    srv = PoolServer(model, params, n_nodes=4, page_size=4,
                     hbm_pages_per_node=8, dtype=F32)
    pool = StoragePool(4, extent_cfg={"n_pages": 4, "page_rows": 8,
                                      "n_cols": 8})
    pool.attach_server(srv)
    corpus = np.arange(24, dtype=np.int32).reshape(6, 4)
    fe = RetrievalFrontend(pool, srv, corpus_tokens=corpus,
                           template=np.arange(8, dtype=np.int32))
    fe.ingest(np.ones((6, 8), np.float32), node_ip=pool.serving_ips()[2])
    long = np.concatenate([np.arange(8), prompts[0]]).astype(np.int32)
    pref = [fe.preferred_node(long, 20)]
    srv.add_request(0, long, node=pref[0])
    pref.append(fe.preferred_node(long, 20))
    pref.append(fe.preferred_node(long, 40))
    pref.append(fe.preferred_node(prompts[1], 8))
    res["preferred"] = pref
    print("RESULT " + json.dumps(res))
"""


@pytest.fixture(scope="module")
def reference():
    """The JAX package's multi-node runs, in one subprocess with four
    forced host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    code = textwrap.dedent(_REFERENCE) % {"gens": GENS}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def _keys(d):
    """JSON's string keys back to ints."""
    return {int(k): v for k, v in d.items()}


@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(jget_arch("granite_3_2b").reduced(),
                              n_layers=2, vocab_size=64)
    jmodel = jget_model(cfg, compute_dtype=jnp.float32, moe_no_drop=True)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(ArchConfig(**dataclasses.asdict(cfg)))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return cfg, (jmodel, jparams), (tmodel, tparams)


@pytest.fixture(scope="module")
def prompts(models):
    rng = np.random.default_rng(0)
    return [rng.integers(0, models[0].vocab_size, 6, dtype=np.int32)
            for _ in range(5)]


@pytest.fixture(scope="module")
def single(models, prompts):
    """The reference's one-node PagedServer: prefill logits and greedy
    outputs (first token from the prefill)."""
    _, (jm, jp), _ = models
    ref = jserve.PagedServer(jm, jp, page_size=4, hbm_pages=64,
                             dtype=jnp.float32)
    logits = [np.asarray(ref.add_request(i, p)) for i, p in enumerate(prompts)]
    out = {i: [int(np.argmax(lg))] for i, lg in enumerate(logits)}
    for i, toks in ref.decode(max(GENS) - 1).items():
        out[i] += toks
    return logits, {i: o[:g] for (i, o), g in zip(out.items(), GENS)}


def _pool(models, n_nodes=4, **kw):
    _, _, (tm, tp) = models
    kw = {"page_size": 4, "hbm_pages_per_node": 8, **kw}
    return PoolServer(tm, tp, n_nodes=n_nodes, device="cpu", **kw)


def _fabric(n, **kw):
    return StoragePool(n, extent_cfg={"device": "cpu", **kw.pop(
        "extent_cfg", {})}, **kw)


@pytest.mark.parametrize("page_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("policy", ["placed", "striped"])
def test_one_node_pool_is_paged_server(models, prompts, policy, page_dtype):
    """A 1-node pool is the single server bit for bit: prefill logits,
    every step's logits, and the h8 and speculative tokens."""
    _, _, (tm, tp) = models
    ref = PagedServer(tm, tp, page_size=4, hbm_pages=32, device="cpu",
                      page_dtype=page_dtype)
    srv = _pool(models, 1, hbm_pages_per_node=32, policy=policy,
                page_dtype=page_dtype)
    for i, p in enumerate(prompts):
        assert torch.equal(ref.add_request(i, p, chunk=4),
                           srv.add_request(i, p, chunk=4))
    for _ in range(3):
        toks = ref.pending_tokens()
        a, b = ref.step(toks), srv.step(toks)
        assert all(torch.equal(a[s], b[s]) for s in a)
        for s, lg in a.items():
            ref.set_pending(s, int(lg.argmax()))
            srv.set_pending(s, int(lg.argmax()))
    assert ref.decode(6, horizon=8) == srv.decode(6, horizon=8)
    assert (ref.decode(6, horizon=8, speculative=True) ==
            srv.decode(6, horizon=8, speculative=True))
    assert srv.node_tier_stats()[0] == {
        k: v for k, v in srv.tier_stats().items()
        if k in srv.node_tier_stats()[0]}


@pytest.mark.parametrize("policy", ["placed", "striped"])
def test_multinode_matches_reference(models, prompts, single, reference,
                                     policy):
    """Four nodes: prefill logits within 1e-4 of the reference's 1-node
    server, its greedy tokens, and the reference pool's placement and
    per-node free pages."""
    ref_logits, ref_out = single
    srv = _pool(models, policy=policy)
    for i, p in enumerate(prompts):
        lg = srv.add_request(i, p)
        np.testing.assert_allclose(lg.numpy(), ref_logits[i], atol=1e-4,
                                   rtol=0)
    want = reference[policy]
    assert [srv.node_of(i) for i in range(5)] == want["node_of"]
    out = srv.decode(max(GENS))
    assert out == _keys(want["decode"])
    assert srv.node_free_pages() == want["free"]
    for i, g in enumerate(GENS):
        assert out[i][:g - 1] == ref_out[i][1:]
    if policy == "placed":
        assert len(set(want["node_of"])) > 1
        victims = srv.fail_node(srv.node_of(0))
        assert victims == reference["fail"]["victims"]
        assert srv.alive_nodes() == reference["fail"]["alive"]
        assert srv.node_free_pages() == reference["fail"]["free"]
        dead = set(range(4)).difference(srv.alive_nodes()).pop()
        with pytest.raises(RuntimeError, match="dead"):
            srv.add_request(9, prompts[0], node=dead)


def test_drain_node_matches_reference(models, prompts, reference):
    """The warm drain: its report, the tokens after it, the placements,
    the parked node and the per-node stats (which sum to the pool's)."""
    srv = _pool(models)
    for i, p in enumerate(prompts):
        srv.add_request(i, p)
    srv.decode(2)
    moved = []
    rep = srv.drain_node(srv.node_of(0),
                         on_migrate=lambda *a: moved.append(a))
    want = reference["drain"]
    assert rep["victims"] == want["victims"]
    assert rep["migrated_pages"] == want["migrated_pages"] == len(moved) > 0
    assert rep["cold"] == want["cold"]
    assert rep["moved"] == _keys(want["moved"])
    assert srv.decode(3) == _keys(want["after"])
    assert [srv.node_of(i) for i in range(5)] == want["node_of"]
    assert srv.parked_nodes() == want["parked"]
    per, agg = srv.node_tier_stats(), srv.tier_stats()
    assert per == want["nodes"]
    assert {k: v for k, v in agg.items()} == want["tier"]
    assert all(agg[k] == sum(p[k] for p in per) for k in per[0])
    with pytest.raises(RuntimeError, match="striped"):
        _pool(models, policy="striped").drain_node(0)


def _router_run(models, prompts, max_requeues=3, kill_after=2, **kw):
    srv = _pool(models)
    pool = _fabric(4, heartbeat_timeout=0.0)
    pool.attach_server(srv)
    router = PoolRouter(srv, pool, max_active=5, max_requeues=max_requeues,
                        **kw)
    for i, (p, g) in enumerate(zip(prompts, GENS)):
        router.submit(Request(rid=i, prompt=p, max_tokens=g))
    for _ in range(kill_after):
        router.step()
    head = router.node_headroom()
    victim = srv.node_of(min(router.active))
    pool.nodes[pool.serving_ips()[victim]].fail()
    stats = router.run_to_completion()
    return router, pool, srv, head, victim, stats


def test_router_failover_matches_reference(models, prompts, single,
                                           reference):
    """Kill the node of a running request after two router steps: its
    sequences requeue at the front, re-prefill on the survivors and
    finish with the uninterrupted run's tokens; the requeue count, the
    control frames, the events and the tier counters are the
    reference's."""
    router, pool, srv, head, victim, stats = _router_run(models, prompts)
    want = reference["failover"]
    out = {r.rid: r.output for r in router.finished}
    assert out == single[1] == _keys(want["out"])
    assert victim == want["victim"] and victim not in srv.alive_nodes()
    assert router.requeues == want["requeues"] >= 1
    assert head == _keys(want["headroom"])
    assert [e[0] for e in pool.events] == want["events"]
    assert "serve-requeue" in want["events"]
    assert pool.driver.stats.control_frames == want["frames"]
    assert stats["tier"] == want["tier"]


def test_requeue_storm_sheds(models, prompts, reference):
    """``max_requeues=0``: the victims of a node kill are shed with a
    recorded reason and the survivors finish as in the reference's run
    (sampled, horizon 4)."""
    router, *_ = _router_run(
        models, prompts, max_requeues=0, kill_after=1, horizon=4,
        sampling=SamplingConfig(temperature=0.8, top_p=0.9, seed=11))
    want = reference["shed"]
    assert sorted(r.rid for r in router.rejected) == want["rejected"] != []
    assert all("lost its node" in r.reject_reason for r in router.rejected)
    assert {r.rid: r.output for r in router.finished} == _keys(want["out"])


def test_striped_pool_fails_fast_on_node_loss(models, prompts):
    srv = _pool(models, 1, hbm_pages_per_node=16, policy="striped")
    pool = _fabric(1, heartbeat_timeout=0.0)
    pool.attach_server(srv)
    router = PoolRouter(srv, pool, max_active=2)
    router.submit(Request(rid=0, prompt=prompts[0], max_tokens=4))
    router.step()
    pool.nodes[pool.serving_ips()[0]].fail()
    with pytest.raises(RuntimeError, match="striped pool lost node"):
        router.run_to_completion()


def test_router_frontend_control_plane_and_capacity(models, prompts):
    """One node: place/free frames cost-accounted and logged at the node;
    a request larger than a node's window is rejected with the
    reference's reason."""
    srv = _pool(models, 1, hbm_pages_per_node=32)
    pool = _fabric(1)
    pool.attach_server(srv)
    router = PoolRouter(srv, pool, max_active=2)
    for i, p in enumerate(prompts[:3]):
        router.submit(Request(rid=i, prompt=p, max_tokens=3))
    assert router.submit(Request(rid=9, prompt=prompts[3],
                                 max_tokens=200)) is False
    assert "a node's window has 32" in router.rejected[0].reject_reason
    assert router.run_to_completion()["requests"] == 3
    log = pool.nodes[pool.serving_ips()[0]].serving_log
    assert [v for v, _ in log].count("place") == 3
    assert [v for v, _ in log].count("free") == 3
    assert pool.driver.stats.control_frames == 6
    assert srv.table.free_pages == srv.hbm_pages


def test_spill_stats_sum_and_planner_admission(models, prompts, reference):
    """Two nodes of four pages: per-node eviction traffic, the aggregate
    equal to the reference's and to the sum of the nodes; the offload
    planner's admission reads the router's ``node_headroom``."""
    srv = _pool(models, 2, hbm_pages_per_node=4)
    pool = _fabric(2)
    pool.attach_server(srv)
    for i, p in enumerate(prompts[:4]):
        srv.add_request(i, p, node=pool.place_sequence(i, 6 + 4))
    for i in range(4):
        srv.decode(3, seqs=[i])
    served = pool.serving_tier_stats()
    assert served == reference["spill"]["served"]
    agg, per = served["pool"], served["nodes"]
    assert agg["page_outs"] > 0
    assert all(agg[k] == sum(p[k] for p in per) for k in per[0])

    router = PoolRouter(srv, pool, max_active=2)
    planner = OffloadPlanner(pool, router=router)
    ips = pool.serving_ips()
    assert router.node_headroom() == {0: 4, 1: 4}
    assert planner._node_admits(ips[0]) and planner._node_admits("1.2.3.4")
    router.active[0] = Request(rid=0, prompt=prompts[0], max_tokens=10)
    assert router.node_headroom()[srv.node_of(0)] == 0
    assert not planner._node_admits(ips[srv.node_of(0)])


def test_preferred_node_matches_reference(models, prompts, reference):
    """RAG placement on a pool: the extent-owning node seeds the prefix,
    the prefix owner wins while it has room, a prompt with neither falls
    back to None."""
    srv = _pool(models)
    pool = _fabric(4, extent_cfg={"n_pages": 4, "page_rows": 8,
                                  "n_cols": 8})
    pool.attach_server(srv)
    fe = RetrievalFrontend(pool, srv,
                           corpus_tokens=np.arange(24, dtype=np.int32)
                           .reshape(6, 4),
                           template=np.arange(8, dtype=np.int32),
                           device="cpu")
    fe.ingest(np.ones((6, 8), np.float32), node_ip=pool.serving_ips()[2])
    long = np.concatenate([np.arange(8), prompts[0]]).astype(np.int32)
    got = [fe.preferred_node(long, 20)]
    srv.add_request(0, long, node=got[0])
    got += [fe.preferred_node(long, 20), fe.preferred_node(long, 40),
            fe.preferred_node(prompts[1], 8)]
    assert got == reference["preferred"]
    assert got[0] == 2


def test_elastic_bucket_and_activation(models):
    """``active=`` rounds the pool up to its pow2 bucket; parked nodes
    take no placement until activated; a dead node cannot rejoin."""
    assert [mesh_bucket(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    srv = _pool(models, 3, active=2)
    assert srv.n_nodes == 4 and srv.alive_nodes() == [0, 1]
    assert srv.parked_nodes() == [2, 3] and srv.active_count == 2
    srv.activate_node(3)
    assert srv.alive_nodes() == [0, 1, 3]
    srv.fail_node(3)
    with pytest.raises(RuntimeError, match="cannot rejoin"):
        srv.activate_node(3)
    with pytest.raises(ValueError, match="placed policy"):
        _pool(models, 2, active=1, policy="striped")
    with pytest.raises(NotImplementedError):
        srv.step_reference({})
