"""The port's ContinuousBatcher (CPU) against the JAX package's on the
same converted weights and numpy prompts: request outputs identical at
horizon 1, horizon 8, speculative, sampled and with chunked admission;
rejection reasons equal; and the invariants of the reference's scheduler
tests on the port (outputs equal isolated serving, pages reclaimed, the
window respected at admission, a retired slot reused)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.runtime import scheduler as jsched  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime.scheduler import (ContinuousBatcher,  # noqa: E402
                                           Request)
from repro_torch.runtime.serve import PagedServer, SamplingConfig  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several test processes
    on the host's cores, and torch's per-process thread pools
    oversubscribe them (the draws here slowed 30x under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(jget_arch("granite_3_2b").reduced(),
                              n_layers=2, vocab_size=64)
    jmodel = jget_model(cfg, compute_dtype=jnp.float32, moe_no_drop=True)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(ArchConfig(**dataclasses.asdict(cfg)))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return cfg, (jmodel, jparams), (tmodel, tparams)


def _server(models, port, **kw):
    _, (jm, jp), (tm, tp) = models
    kw = {"page_size": 4, "hbm_pages": 32, **kw}
    if port:
        return PagedServer(tm, tp, device="cpu", **kw)
    return jserve.PagedServer(jm, jp, dtype=jnp.float32, **kw)


def _prompts(cfg):
    rng = np.random.default_rng(1)
    return ([np.full(12 + i, c, np.int32) for i, c in enumerate((5, 9, 13))]
            + [rng.integers(0, cfg.vocab_size, 7, dtype=np.int32)])


GENS = [5, 9, 3, 7]
SAMPLED = SamplingConfig(temperature=0.8, top_p=0.9, seed=4)
MODES = {
    "h1": dict(horizon=1),
    "h8": dict(horizon=8),
    "speculative": dict(horizon=8, speculative=True),
    "sampled": dict(horizon=8, sampling=SAMPLED),
    "sampled_h1": dict(horizon=1, sampling=SAMPLED),
    "speculative_sampled": dict(horizon=8, speculative=True,
                                sampling=SAMPLED),
    "chunked": dict(horizon=8, speculative=True, prefill_chunk=5),
}


def _run(models, port, mode, **server_kw):
    kw = dict(MODES[mode])
    if not port and "sampling" in kw:
        s = kw["sampling"]
        kw["sampling"] = jserve.SamplingConfig(s.temperature, s.top_p, s.seed)
    server = _server(models, port, **server_kw)
    cls, req = ((ContinuousBatcher, Request) if port else
                (jsched.ContinuousBatcher, jsched.Request))
    batcher = cls(server, max_active=2, **kw)
    for i, (p, g) in enumerate(zip(_prompts(models[0]), GENS)):
        batcher.submit(req(rid=i, prompt=p, max_tokens=g))
    stats = batcher.run_to_completion()
    return {r.rid: r.output for r in batcher.finished}, stats, server


@pytest.mark.parametrize("mode", MODES)
def test_batcher_outputs_match_jax(models, mode):
    got, stats, server = _run(models, True, mode)
    want, jstats, _ = _run(models, False, mode)
    assert got == want
    assert {k: len(v) for k, v in got.items()} == dict(enumerate(GENS))
    assert stats["requests"] == 4 and stats["iters"] == jstats["iters"]
    assert set(stats) == set(jstats)
    assert stats["tier"] == jstats["tier"]
    assert server.table.free_pages == server.hbm_pages


def test_speculative_batcher_matches_per_token_schedule(models):
    assert _run(models, True, "speculative")[0] == \
        _run(models, True, "h1")[0]


def test_rejection_reasons_match_jax(models):
    cfg = models[0]

    def run(port):
        server = _server(models, port, hbm_pages=6)
        cls, req = ((ContinuousBatcher, Request) if port else
                    (jsched.ContinuousBatcher, jsched.Request))
        batcher = cls(server, max_active=1, max_waiting=2)
        rng = np.random.default_rng(2)
        p = lambda n: rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
        accepted = [batcher.submit(req(rid=0, prompt=p(30), max_tokens=4)),
                    batcher.submit(req(rid=1, prompt=p(5), max_tokens=3)),
                    batcher.submit(req(rid=2, prompt=p(5), max_tokens=3,
                                       deadline_s=0.0)),
                    batcher.submit(req(rid=3, prompt=p(5), max_tokens=3))]
        stats = batcher.run_to_completion()
        return (accepted, {r.rid: r.reject_reason for r in batcher.rejected},
                {r.rid: r.output for r in batcher.finished},
                stats["rejected"])
    got, want = run(True), run(False)
    # rid 0 can never fit, rid 3 meets a full queue, rid 2's deadline
    # passes while it waits; their reasons differ only in the seconds
    assert got[0] == want[0] == [False, True, True, False]
    strip = {k: v.split(" exceeded")[0] for k, v in got[1].items()}
    assert strip == {k: v.split(" exceeded")[0] for k, v in want[1].items()}
    assert set(got[1]) == {0, 2, 3}
    assert got[2] == want[2] and got[3] == want[3] == 3


# ---------------------------------------------------------------------------
# tests/test_scheduler.py's invariants, on the port
# ---------------------------------------------------------------------------


def test_continuous_batching_matches_isolated(models):
    cfg = models[0]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 6, dtype=np.int32)
               for _ in range(4)]
    gens = [3, 5, 2, 4]
    refs = []
    for p, g in zip(prompts, gens):
        server = _server(models, True, hbm_pages=64)
        last = server.add_request(0, p)
        refs.append([int(last.argmax())] +
                    server.decode(g - 1, seqs=[0])[0])
    server = _server(models, True, hbm_pages=10)
    sched = ContinuousBatcher(server, max_active=2)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        sched.submit(Request(rid=i, prompt=p, max_tokens=g))
    assert sched.run_to_completion()["requests"] == 4
    assert {r.rid: r.output for r in sched.finished} == dict(enumerate(refs))


def test_pages_reclaimed_after_completion(models):
    cfg = models[0]
    rng = np.random.default_rng(1)
    server = _server(models, True, hbm_pages=8)
    sched = ContinuousBatcher(server, max_active=1)
    for i in range(3):
        sched.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, 5, dtype=np.int32), max_tokens=3))
    assert sched.run_to_completion()["requests"] == 3
    assert server.table.free_pages == server.hbm_pages
    assert server.table.resident_pages == 0
    assert server.table.host_pages == 0
    assert server.sequence_ids() == [] and server._history == {}


def test_admission_respects_window(models):
    cfg = models[0]
    rng = np.random.default_rng(2)
    server = _server(models, True, hbm_pages=4)
    sched = ContinuousBatcher(server, max_active=4)
    # each request needs 3 pages; the window holds one at a time
    for i in range(2):
        sched.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, 6, dtype=np.int32), max_tokens=4))
    sched.step()
    assert len(sched.active) <= 1
    assert sched.run_to_completion()["requests"] == 2


def test_retired_slot_reused_by_waiting_request(models):
    cfg = models[0]
    rng = np.random.default_rng(3)
    server = _server(models, True, hbm_pages=3)
    sched = ContinuousBatcher(server, max_active=2)
    for i in range(2):
        sched.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, 6, dtype=np.int32), max_tokens=4))
    sched.step()
    assert list(sched.active) == [0]
    assert sched.run_to_completion()["requests"] == 2
    assert [r.rid for r in sched.finished] == [0, 1]
    assert server.table.free_pages == server.hbm_pages


def test_batcher_argument_errors(models):
    server = _server(models, True)
    with pytest.raises(ValueError, match="speculative"):
        ContinuousBatcher(server, horizon=1, speculative=True)
    with pytest.raises(ValueError, match="horizon"):
        ContinuousBatcher(server, horizon=0)
    with pytest.raises(ValueError, match="prefill_chunk"):
        ContinuousBatcher(server, prefill_chunk=0)
