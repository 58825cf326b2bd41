"""Elastic pool serving on the port (CPU): the autoscaler's decisions
against the JAX package's on the duck-typed router and pool of the
reference's tests (the same sequence of scale-ups, drains and SLO
recoveries), ``scale_to`` against the pool's capacity bucket as in the
reference, and the port's zero-drop drain and join: a drain under a
lossy fabric with stragglers, a join under load followed by a drain back,
and a cold drain, each token-identical to the undisturbed run (chunked
prefill, speculation and temperature > 0 sampling), with the migrations
counted in MIGRATE frames and ``control_plane_terms``."""
import dataclasses
import re
import time
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.core import storage_pool as jpool  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.runtime import autoscaler as jauto  # noqa: E402
from repro.runtime import pool as jpoolsrv  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import analytical as A  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.core.storage_pool import StoragePool  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import autoscaler as tauto  # noqa: E402
from repro_torch.runtime.pool import PoolServer  # noqa: E402
from repro_torch.runtime.scheduler import PoolRouter, Request  # noqa: E402
from repro_torch.runtime.serve import SamplingConfig  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (several test processes share the
    host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# autoscaler decisions against the reference (stub router / pool)
# ---------------------------------------------------------------------------


class _StubReq:
    def __init__(self, t_arrive, t_first=None, t_done=None, n_out=4):
        now = time.monotonic()
        self.t_arrive = now + t_arrive
        self.t_first = now + (t_first if t_first is not None else t_arrive)
        self.t_done = now + (t_done if t_done is not None else t_arrive)
        self.output = [0] * n_out


class _StubTable:
    def __init__(self, free):
        self.free = free

    def shard_free_pages(self, s):
        return self.free[s]


class _StubServer:
    def __init__(self, n_nodes, active, free_per_node):
        self.n_nodes = n_nodes
        self.pages_per_node = 16
        self._alive = list(range(active))
        self.table = _StubTable(free_per_node)

    def alive_nodes(self):
        return list(self._alive)


class _StubPool:
    def __init__(self, server):
        self.server = server
        self.grows = []
        self.drains = []

    def grow_serving(self, n):
        self.grows.append(n)
        self.server._alive = list(range(n))

    def drain_serving_node(self, node):
        self.drains.append(node)
        self.server._alive.remove(node)
        return {"victims": [], "migrated_pages": 0, "cold": [],
                "moved": {}}


class _StubRouter:
    def __init__(self, server):
        self.server = server
        self.waiting = deque()
        self.prefilling = {}
        self.active = {}
        self.finished = []


def _queue_breach(mod):
    srv = _StubServer(4, 2, [16, 16, 16, 16])
    pool, router = _StubPool(srv), _StubRouter(srv)
    asc = mod.Autoscaler(router, pool, slo=mod.ServingSLO(queue_depth=3),
                         min_nodes=2, cooldown=3, sustain=100)
    for _ in range(6):
        router.waiting.append(_StubReq(-0.01))
    for _ in range(6):
        asc.tick()
    return asc, pool


def _ttft_breach(mod):
    srv = _StubServer(4, 3, [16, 16, 2, 16])
    pool, router = _StubPool(srv), _StubRouter(srv)
    asc = mod.Autoscaler(router, pool, slo=mod.ServingSLO(ttft_p99_s=0.5),
                         min_nodes=1, cooldown=0, sustain=2,
                         headroom_frac=0.5, window=1)
    router.finished = [_StubReq(-2.0, t_first=-0.5) for _ in range(4)]
    asc.tick()
    router.finished.extend(_StubReq(-2.0, t_first=-1.9) for _ in range(8))
    for _ in range(5):
        asc.tick()
    return asc, pool


def _no_absorbing_room(mod):
    srv = _StubServer(2, 2, [8, 2])
    pool, router = _StubPool(srv), _StubRouter(srv)
    asc = mod.Autoscaler(router, pool, slo=mod.ServingSLO(), min_nodes=1,
                         cooldown=0, sustain=1, headroom_frac=0.0)
    for _ in range(5):
        asc.tick()
    return asc, pool


def _summary(asc, pool):
    """Decisions without their wall-clock numbers: (tick, kind, nodes,
    the reason's words), the recoveries' count, the pool's calls."""
    number = r"-?\d+(\.\d+)?(e[-+]?\d+)?"
    return ([(d.tick, d.kind, d.nodes, re.sub(number, "#", d.reason))
             for d in asc.decisions], len(asc.recoveries), pool.grows,
            pool.drains)


@pytest.mark.parametrize("scenario", [_queue_breach, _ttft_breach,
                                      _no_absorbing_room])
def test_autoscaler_decisions_match_reference(scenario):
    got = _summary(*scenario(tauto))
    assert got == _summary(*scenario(jauto))
    decisions = got[0]
    if scenario is _queue_breach:
        assert [d[1] for d in decisions] == ["up", "up"]
        assert got[2] == [3, 4] and "queue depth" in decisions[0][3]
    elif scenario is _ttft_breach:
        assert [d[1] for d in decisions][:2] == ["up", "down"]
        assert got[1] == 1 and got[3][0] in (0, 1, 3)
    else:
        assert decisions == [] and got[3] == []


# ---------------------------------------------------------------------------
# the port's elastic pool: drain, join, cold path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(jget_arch("granite_3_2b").reduced(),
                              n_layers=2, vocab_size=64)
    jmodel = jget_model(cfg, compute_dtype=jnp.float32, moe_no_drop=True)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(ArchConfig(**dataclasses.asdict(cfg)))
    return (cfg, tmodel, params_from_jax(jax.device_get(jparams),
                                         device="cpu"), jmodel, jparams)


def test_scale_to_rejects_nodes_beyond_the_bucket(tiny):
    """With a server attached, a node that could never serve pages is
    rejected up front on both packages; nothing is half-attached."""
    _, tm, tp, jm, jp = tiny
    pools = [(PoolServer(tm, tp, n_nodes=1, page_size=4,
                         hbm_pages_per_node=16, device="cpu"),
              StoragePool(1, extent_cfg={"device": "cpu"})),
             (jpoolsrv.PoolServer(jm, jp, n_nodes=1, page_size=4,
                                  hbm_pages_per_node=16, dtype=jnp.float32),
              jpool.StoragePool(1))]
    for srv, pool in pools:
        pool.attach_server(srv)
        with pytest.raises(RuntimeError, match="could never serve"):
            pool.scale_to(2)
        assert len(pool.nodes) == 1
        with pytest.raises(ValueError, match="grows the fabric"):
            pool.scale_to(0)
        with pytest.raises(RuntimeError, match="bucket"):
            pool.grow_serving(2)
    plain = StoragePool(2, extent_cfg={"device": "cpu"})
    plain.scale_to(4)
    assert len(plain.nodes) == 4 and ("scale", "4") in plain.events


SAMP = SamplingConfig(temperature=0.8, top_p=0.9, seed=11)
GENS = [6, 8, 5, 7, 6]


def _prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, 12, dtype=np.int32)
            for _ in range(5)]


def _elastic(tiny, active=None, fabric=4, plan=None):
    cfg, model, params = tiny[:3]
    srv = PoolServer(model, params, n_nodes=4, active=active, page_size=4,
                     hbm_pages_per_node=16, device="cpu")
    pool = StoragePool(fabric, heartbeat_timeout=1e9,
                       extent_cfg={"device": "cpu"})
    pool.attach_server(srv)
    if plan is not None:
        pool.attach_faults(plan)
    router = PoolRouter(srv, pool, max_active=5, horizon=4, prefill_chunk=4,
                        speculative=True, sampling=SAMP)
    for i, (p, g) in enumerate(zip(_prompts(cfg), GENS)):
        router.submit(Request(rid=i, prompt=p, max_tokens=g))
    return srv, pool, router


@pytest.fixture(scope="module")
def static(tiny):
    srv, pool, router = _elastic(tiny)
    router.run_to_completion()
    assert not router.rejected
    assert pool.driver.stats.migrate_frames == 0
    return {r.rid: list(r.output) for r in router.finished}


def _outputs(router):
    return {r.rid: list(r.output) for r in router.finished}


def test_drain_under_chaos_token_identical_and_counted(tiny, static):
    """A drain while sequences decode, under a lossy fabric and
    stragglers on every node: token-identical outputs, nothing shed, one
    MIGRATE frame per moved page (priced by ``control_plane_terms``),
    chaos retransmits in the delivery counters."""
    srv, pool, router = _elastic(tiny, active=4, plan=FaultPlan(
        seed=13, p_drop=0.12, p_corrupt=0.15, p_dup=0.08, p_delay=0.08,
        stragglers={"*": 4.0}))
    for _ in range(4):
        router.step()
    victim = next(n for n in (srv.node_of(i) for i in range(5))
                  if n is not None)
    rep = pool.drain_serving_node(victim)
    assert rep["migrated_pages"] > 0, rep
    router.run_to_completion()
    assert _outputs(router) == static and not router.rejected
    st = pool.driver.stats
    assert st.migrate_frames == rep["migrated_pages"]
    assert st.migrate_bytes == rep["migrated_pages"] * srv.store.page_bytes()
    assert st.retransmits > 0
    fi = pool.fault_injector.stats
    assert fi.dropped + fi.corrupted + fi.delayed > 0
    assert victim in srv.parked_nodes()
    terms = A.control_plane_terms(st, sum(GENS))
    assert terms["migrate_frames"] == rep["migrated_pages"]
    assert terms["retransmits"] == st.retransmits
    assert ("serve-drain", f"{pool.serving_ips()[victim]}:{victim}") in \
        pool.events


def test_join_under_load_then_drain_back(tiny, static):
    """A pool of bucket 4 starting at two nodes: ``scale_to`` wires and
    activates two more under load, draining back to two keeps every
    request, a drained node rejoins through ``grow_serving``, and the
    outputs are the static run's."""
    srv, pool, router = _elastic(tiny, active=2, fabric=2)
    assert srv.alive_nodes() == [0, 1]
    router.step()
    router.step()
    pool.scale_to(4)
    assert srv.alive_nodes() == [0, 1, 2, 3]
    assert all(ip is not None for ip in pool.serving_ips())
    for _ in range(3):
        router.step()
    for node in (3, 2):
        if node in srv.alive_nodes():
            pool.drain_serving_node(node)
    assert len(srv.alive_nodes()) == 2
    router.run_to_completion()
    assert _outputs(router) == static and not router.rejected
    pool.grow_serving(3)
    assert len(srv.alive_nodes()) == 3
    router.submit(Request(rid=99, prompt=_prompts(tiny[0])[0], max_tokens=4))
    router.run_to_completion()
    assert 99 in {r.rid for r in router.finished}
    assert sum(e[0] == "serve-join" for e in pool.events) == 3


def test_cold_drain_requeues_when_nothing_fits(tiny, static):
    """No surviving window can absorb the victim's pages: the drain goes
    cold, its sequences requeue through the failover path, and they
    still finish with the static run's tokens."""
    srv, pool, router = _elastic(tiny, active=4)
    for _ in range(4):
        router.step()
    victim = next(n for n in srv.alive_nodes() for i in range(5)
                  if srv.node_of(i) == n
                  and srv.table.resident_on_shard(i, n))
    stash = {}
    for s in srv.alive_nodes():
        if s != victim:
            srv.table.release_shard_cache(s)
            stash[s] = srv.table._free[s][:]
            srv.table._free[s].clear()
    rep = pool.drain_serving_node(victim)
    for s, pages in stash.items():
        srv.table._free[s].extend(pages)
    assert rep["cold"] and rep["migrated_pages"] == 0
    router.run_to_completion()
    assert _outputs(router) == static and not router.rejected
    assert router.requeues >= 1
