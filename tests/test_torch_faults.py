"""The port's fault injector and the chaos fabric (CPU) against the JAX
package: ``FaultPlan``'s JSON round trip, validation and presets equal
to the reference's; the same plan over the same frames gives the same
deliveries and stats on both packages; the Ether-oN fabric and a
``StoragePool`` under the ``lossy`` and ``storm`` presets reassemble the
payload bytes with the reference's counters; scheduled crashes and
stragglers drive the pool's failover and suspect sweep as in the
reference; and a chaos run of the port's pool router (lossy fabric, a
scheduled node crash, a straggler) completes token-identical to its
fault-free run with the driver's recovery counters equal to what the
injector did."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.core import ether_on as jeth  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import storage_pool as jpool  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import analytical as A  # noqa: E402
from repro_torch.core import ether_on as teth  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import storage_pool as tpool  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime.pool import PoolServer  # noqa: E402
from repro_torch.runtime.scheduler import PoolRouter, Request  # noqa: E402
from repro_torch.runtime.serve import SamplingConfig  # noqa: E402

HOST = "10.0.0.1"
PKG = {"port": (teth, tfaults, tpool), "jax": (jeth, jfaults, jpool)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (several test processes share the
    host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(side, **kw):
    return PKG[side][1].FaultPlan(**kw)


def test_fault_plan_roundtrip_presets_and_validation(tmp_path):
    kw = dict(seed=3, p_drop=0.1, p_corrupt=0.02, p_dup=0.05, p_delay=0.04,
              delay_ops=2, crashes={"10.0.1.2": 5},
              stragglers={"10.0.1.3": 4.0})
    plan, jplan = _plan("port", **kw), _plan("jax", **kw)
    assert plan.to_json() == jplan.to_json()
    assert tfaults.FaultPlan.from_json(jplan.to_json()) == plan
    assert plan.lossy and not tfaults.FaultPlan().lossy
    assert set(tfaults.PRESET_PLANS) == set(jfaults.PRESET_PLANS)
    for name, p in tfaults.PRESET_PLANS.items():
        assert p.to_json() == jfaults.PRESET_PLANS[name].to_json()
        assert tfaults.load_plan(name) == p
    assert tfaults.load_plan(plan.to_json()) == plan
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    assert tfaults.load_plan(str(path)) == plan
    for bad, match in (({"p_drop": 1.5}, "p_drop"), ({"delay_ops": 0},
                                                     "delay_ops")):
        with pytest.raises(ValueError, match=match):
            tfaults.FaultPlan(**bad)


@pytest.mark.parametrize("seed", [9, 21])
def test_injector_replay_equals_reference(seed):
    """The same plan over the same frame sequence: identical delivery
    lists (seq, CRC verdict, payload) and stats on both packages, in
    both directions, crashes and stragglers included."""
    kw = dict(seed=seed, p_drop=0.2, p_corrupt=0.1, p_dup=0.1,
              p_delay=0.1, delay_ops=2, crashes={"10.0.1.3": 30},
              stragglers={"10.0.1.2": 3.0})

    def run(side):
        eth, faults, _ = PKG[side]
        inj = faults.FaultInjector(faults.FaultPlan(**kw))
        crashed, lat = [], []
        inj.on_crash = crashed.append
        inj.on_latency = lambda ip, m: lat.append((ip, m))
        seen = []
        for i in range(60):
            ip = "10.0.1.2" if i % 3 else "10.0.1.3"
            src, dst, way = ((HOST, ip, "down") if i % 2 else
                             (ip, HOST, "up"))
            f = eth.EthernetFrame(src, dst, b"m%03d" % i).seal()
            f.seq = i
            seen += [(g.seq, g.verify(), g.payload)
                     for g in inj.transit(f, way, ip)]
        return seen, inj.stats.as_dict(), crashed, lat

    got, want = run("port"), run("jax")
    assert got == want
    assert got[1]["dropped"] and got[1]["corrupted"] and got[2]


def _fabric(side, plan=None):
    eth, faults, _ = PKG[side]
    drv = eth.EtherONDriver(HOST)
    dev = eth.DockerSSDEndpoint("10.0.1.2")
    rec = []
    dev.set_handler(lambda fr: rec.append(fr.payload))
    drv.attach(dev)
    inj = None
    if plan is not None:
        inj = faults.FaultInjector(faults.FaultPlan(**plan))
        drv.attach_faults(inj)
    return drv, dev, rec, inj


def _exercise(drv, dev, n_down=12, up_bytes=5000):
    sent = [b"msg-%03d" % i for i in range(n_down)]
    for p in sent:
        drv.transmit(_frame(drv, dev.ip, p))
    blob = np.random.default_rng(0).integers(
        0, 256, up_bytes, dtype=np.uint8).tobytes()
    dev.send_to_host(blob, HOST)
    chunks = []
    while (f := drv.poll()) is not None:
        chunks.append(f.payload)
    return sent, blob, b"".join(chunks)


def _frame(drv, ip, payload):
    eth = teth if isinstance(drv, teth.EtherONDriver) else jeth
    return eth.EthernetFrame(HOST, ip, payload)


def _preset_kwargs(name):
    return dataclasses.asdict(tfaults.PRESET_PLANS[name])


@pytest.mark.parametrize("preset", ["lossy", "storm"])
def test_fabric_under_presets_equals_reference(preset):
    """Under drop + corrupt + dup + reorder both directions reassemble
    byte-identically, every corruption is NACKed, every duplicate
    deduped, and the driver's and injector's counters are the
    reference's."""
    out = {}
    for side in PKG:
        drv, dev, rec, inj = _fabric(side, _preset_kwargs(preset))
        sent, blob, up = _exercise(drv, dev)
        assert rec == sent and up == blob, side
        out[side] = (vars(drv.stats), inj.stats.as_dict())
    stats, inj = out["port"]
    assert out["port"] == out["jax"]
    assert stats["retransmits"] > 0 and stats["backoff_us"] > 0
    assert inj["corrupted"] > 0 and stats["nacks"] == inj["corrupted"]
    assert stats["dup_frames"] >= inj["duplicated"] > 0


def test_zero_fault_plan_costs_byte_identical():
    """An attached injector with every probability zero costs exactly
    what the bare fabric costs; every reliability counter stays 0."""
    runs = [_fabric("port"), _fabric("port", {})]
    for drv, dev, rec, _ in runs:
        sent, blob, up = _exercise(drv, dev)
        assert rec == sent and up == blob
    a, b = (vars(r[0].stats) for r in runs)
    assert a == b
    assert all(b[k] == 0 for k in ("retransmits", "nacks", "dup_frames",
                                   "backoff_us"))


@pytest.mark.parametrize("preset", ["lossy", "storm"])
def test_storage_pool_under_presets_equals_reference(preset):
    """A StoragePool with the preset attached: serving control frames to
    every node and a migrate frame reach their nodes intact and in
    order, with the reference's fabric counters, node logs and events."""
    out = {}
    for side, (_, faults, pool_mod) in PKG.items():
        kw = {"extent_cfg": {"device": "cpu"}} if side == "port" else {}
        pool = pool_mod.StoragePool(3, **kw)
        inj = pool.attach_faults(faults.PRESET_PLANS[preset])
        ips = pool.alive_nodes()
        for i in range(20):
            pool.driver.send_control(ips[i % 3], "place", i, extra=str(i))
        pool.driver.send_migrate(ips[1], 4, 0, 4096, 0, 1)
        pool._drain_acks()
        out[side] = (vars(pool.driver.stats), inj.stats.as_dict(),
                     [pool.nodes[ip].serving_log for ip in ips],
                     pool.events)
    assert out["port"] == out["jax"]
    stats, inj, logs, _ = out["port"]
    assert inj["dropped"] + inj["corrupted"] + inj["duplicated"] > 0
    assert stats["nacks"] == inj["corrupted"]
    assert [e for log in logs for e in log if e[0] == "place"] == sorted(
        [("place", i) for i in range(20)], key=lambda e: (e[1] % 3, e[1]))
    terms = A.control_plane_terms(types.SimpleNamespace(**stats), 100)
    assert terms["retransmits"] == stats["retransmits"] > 0
    assert terms["control_frames"] == 20 and terms["migrate_frames"] == 1


def test_scheduled_crash_and_straggler_equal_reference():
    """A crash scheduled on the op clock fails the node and runs the
    pool's failover; a straggler's latency turns it suspect and clears;
    events and the unreachable path as in the reference."""
    out = {}
    for side, (eth, faults, pool_mod) in PKG.items():
        kw = {"extent_cfg": {"device": "cpu"}} if side == "port" else {}
        pool = pool_mod.StoragePool(4, **kw)
        ips = pool.alive_nodes()
        inj = pool.attach_faults(faults.FaultPlan(
            crashes={ips[1]: 3}, stragglers={ips[0]: 8.0}))
        for _ in range(6):
            pool.driver.send_control(ips[0], "ping", 0)
        pool._drain_acks()
        assert inj.node_crashed(ips[1])
        with pytest.raises(eth.EtherONError, match="node down"):
            pool.driver.send_control(ips[1], "ping", 0)
        pool.check_heartbeats()
        suspects = pool.suspect_nodes()
        pool.nodes[ips[0]].latency_ema_ms = 1.0
        pool.check_heartbeats()
        out[side] = (pool.alive_nodes(), suspects, pool.suspect_nodes(),
                     pool.events, vars(pool.driver.stats))
    assert out["port"] == out["jax"]
    alive, suspects, cleared, events, _ = out["port"]
    assert len(alive) == 3 and suspects and not cleared
    assert events[0][0] == "fault-crash"


# ---------------------------------------------------------------------------
# chaos on the port's pool router
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(jget_arch("granite_3_2b").reduced(),
                              n_layers=2, vocab_size=64)
    from repro.models.api import get_model as jget_model
    jmodel = jget_model(cfg, compute_dtype=jnp.float32, moe_no_drop=True)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(ArchConfig(**dataclasses.asdict(cfg)))
    return cfg, tmodel, params_from_jax(jax.device_get(jparams),
                                        device="cpu")


def _chaos_run(tiny, plan_of=None, **router_kw):
    cfg, model, params = tiny
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 6, dtype=np.int32)
               for _ in range(5)]
    srv = PoolServer(model, params, n_nodes=4, page_size=4,
                     hbm_pages_per_node=8, device="cpu")
    pool = tpool.StoragePool(4, heartbeat_timeout=0.0,
                             extent_cfg={"device": "cpu"})
    pool.attach_server(srv)
    if plan_of is not None:
        pool.attach_faults(plan_of(pool))
    router = PoolRouter(srv, pool, max_active=5, horizon=4, **router_kw)
    for i, (p, g) in enumerate(zip(prompts, [4, 6, 3, 5, 4])):
        router.submit(Request(rid=i, prompt=p, max_tokens=g))
    router.run_to_completion()
    return {r.rid: r.output for r in router.finished}, pool, router


@pytest.mark.parametrize("sampled", [False, True])
def test_chaos_run_is_token_identical_to_fault_free(tiny, sampled):
    """A lossy fabric, a scheduled mid-run node crash and a straggler:
    the run completes with the fault-free run's tokens (greedy and
    sampled), the crash requeues through the router, and every recovery
    action shows in the counters (zero on the fault-free run)."""
    kw = ({"sampling": SamplingConfig(temperature=0.8, top_p=0.9, seed=11)}
          if sampled else {})
    ref, ref_pool, _ = _chaos_run(tiny, **kw)

    def plan_of(pool):
        ips = pool.serving_ips()
        return tfaults.FaultPlan(seed=7, p_drop=0.08, p_corrupt=0.05,
                                 p_dup=0.06, p_delay=0.06, delay_ops=2,
                                 crashes={ips[1]: 12},
                                 stragglers={ips[0]: 8.0})

    out, pool, router = _chaos_run(tiny, plan_of, **kw)
    assert out == ref
    victim = pool.serving_ips()[1]
    assert victim not in pool.alive_nodes()
    assert ("fault-crash", victim) in pool.events
    assert any(e[0] == "serve-requeue" for e in pool.events)
    st, fi = pool.driver.stats, pool.fault_injector.stats
    assert st.retransmits > 0 and st.nacks == fi.corrupted > 0
    assert st.dup_frames >= fi.duplicated > 0
    rs = ref_pool.driver.stats
    assert rs.retransmits == rs.nacks == rs.dup_frames == 0
    assert rs.backoff_us == 0.0


def test_node_death_during_chunked_admission_requeues(tiny):
    """A node dies after an admission opened on it (placement recorded
    at ``begin_request``) but before its first prefill chunk allocated
    a page: ``fail_node`` counts that sequence as a victim, the router
    requeues it, and every request finishes with the fault-free run's
    tokens."""
    kw = {"sampling": SamplingConfig(temperature=0.8, top_p=0.9, seed=11),
          "prefill_chunk": 4}
    ref, _, _ = _chaos_run(tiny, **kw)
    cfg, model, params = tiny
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 6, dtype=np.int32)
               for _ in range(5)]
    srv = PoolServer(model, params, n_nodes=4, page_size=4,
                     hbm_pages_per_node=8, device="cpu")
    pool = tpool.StoragePool(4, heartbeat_timeout=0.0,
                             extent_cfg={"device": "cpu"})
    pool.attach_server(srv)
    router = PoolRouter(srv, pool, max_active=5, horizon=4, **kw)
    for i, (p, g) in enumerate(zip(prompts, [4, 6, 3, 5, 4])):
        router.submit(Request(rid=i, prompt=p, max_tokens=g))
    # one admission pass opens every admission but chunks only the
    # first: the rest are placed with no page allocated
    router._admit()
    rid = [r for r in router.prefilling if srv.table.length(r) == 0][0]
    victim = srv.node_of(rid)
    assert victim is not None
    assert rid not in srv.table.sequences_on_shard(victim)
    pool.nodes[pool.serving_ips()[victim]].fail()
    router.run_to_completion()
    assert {r.rid: r.output for r in router.finished} == ref
    assert router.requeues >= 1 and victim not in srv.alive_nodes()
