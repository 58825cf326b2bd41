"""The port's analytical models (``repro_torch.core.analytical``,
``repro_torch.core.isp_perf``) against the JAX package's copies: every
function gives the reference's output exactly (``==`` on floats, tuples
and dicts) over the model zoo x the four configurations, the Table-2
workloads x the six models, the Fig-13 sweeps, the fitters and the
serving terms fed the same counters; then the claims of
``tests/test_analytical.py`` restated on the port's copies."""
import dataclasses
import types

import pytest

from repro.core import analytical as JA
from repro.core import isp_perf as JI
from repro_torch.core import analytical as A
from repro_torch.core import isp_perf as I


def _rows(xs):
    return [dataclasses.astuple(x) for x in xs]


# ---------------------------------------------------------------------------
# tables and constants


def test_tables_equal():
    assert _rows(A.POOL_LLMS) == _rows(JA.POOL_LLMS)
    assert dataclasses.asdict(A.HW()) == dataclasses.asdict(JA.HW())
    assert A.CONFIGS == JA.CONFIGS
    assert A.PAGE_DTYPE_BYTES == JA.PAGE_DTYPE_BYTES
    assert [A.config_args(c) for c in A.CONFIGS] == \
        [JA.config_args(c) for c in JA.CONFIGS]
    assert [A.nodes_for(m) for m in A.POOL_LLMS] == \
        [JA.nodes_for(m) for m in JA.POOL_LLMS]
    for n in (1, 2, 4, 16, 64, 128):
        assert A.factorizations(n) == JA.factorizations(n)
    for dt in A.PAGE_DTYPE_BYTES:
        for hd in (0, 1, 64, 96, 128):
            assert A.page_dtype_bytes_per_elem(dt, hd) == \
                JA.page_dtype_bytes_per_elem(dt, hd)
    assert _rows(I.WORKLOADS) == _rows(JI.WORKLOADS)
    assert I.MODELS == JI.MODELS and I.COMPONENTS == JI.COMPONENTS
    assert dataclasses.asdict(I.IspCosts()) == \
        dataclasses.asdict(JI.IspCosts())


# ---------------------------------------------------------------------------
# Fig 12 / 13 models


@pytest.mark.parametrize("mi", range(len(JA.POOL_LLMS)),
                         ids=[m.name for m in JA.POOL_LLMS])
@pytest.mark.parametrize("config", JA.CONFIGS)
def test_model_by_config_equal(mi, config):
    """step_time, generation_time and best_parallelism of every model x
    configuration, at the calibrated bf16 pricing and at each page
    format."""
    m, jm = A.POOL_LLMS[mi], JA.POOL_LLMS[mi]
    ca = A.config_args(config)
    n = A.nodes_for(m)
    for dt in (None, "fp32", "bf16", "int8", "fp8"):
        assert A.kv_bytes_per_token(m, A.HW(), dt) == \
            JA.kv_bytes_per_token(jm, JA.HW(), dt)
        for t in (1, 77, 4096):
            kw = dict(t=t, batch=n, dp=1, tp=n // 2, pp=2, **ca,
                      page_dtype=dt)
            assert A.step_time(m, **kw) == JA.step_time(jm, **kw)
        kw = dict(seq_len=2048, batch=n, dp=2, tp=n // 4, pp=2, **ca,
                  page_dtype=dt)
        assert A.generation_time(m, **kw) == JA.generation_time(jm, **kw)
    for seq_len, batch in ((1024, n), (32768, 4 * n)):
        kw = dict(n_nodes=n, seq_len=seq_len, batch=batch, **ca)
        assert A.best_parallelism(m, **kw) == JA.best_parallelism(jm, **kw)


@pytest.mark.parametrize("seq_len,batch_per_node",
                         [(32768, 1), (4096, 4)])
def test_evaluate_pool_equal(seq_len, batch_per_node):
    got = A.evaluate_pool(seq_len, batch_per_node)
    want = JA.evaluate_pool(seq_len, batch_per_node)
    assert got == want
    assert A.headline_ratios(got) == JA.headline_ratios(want)


@pytest.mark.parametrize("name", [m.name for m in JA.POOL_LLMS])
def test_sweeps_equal(name):
    rows = A.seq_sensitivity(name)
    assert rows == JA.seq_sensitivity(name)
    assert A.crossover_point(rows) == JA.crossover_point(rows)
    assert A.seq_sensitivity(name, [300, 5000]) == \
        JA.seq_sensitivity(name, [300, 5000])
    assert A.batch_sensitivity(name) == JA.batch_sensitivity(name)
    assert A.batch_sensitivity(name, 1024, (1, 8)) == \
        JA.batch_sensitivity(name, 1024, (1, 8))


def test_crossover_never():
    rows = [{"seq_len": 64, "speedup": 0.5}]
    assert A.crossover_point(rows) == JA.crossover_point(rows) == -1


# ---------------------------------------------------------------------------
# Fig 3 / 11 models and Table 2


@pytest.mark.parametrize("wi", range(len(JI.WORKLOADS)),
                         ids=[f"{w.program}-{w.name}" for w in JI.WORKLOADS])
def test_workload_by_model_equal(wi):
    w, jw = I.WORKLOADS[wi], JI.WORKLOADS[wi]
    assert I.host_components(w, I.IspCosts()) == \
        JI.host_components(jw, JI.IspCosts())
    for model in JI.MODELS:
        assert I.components(w, model) == JI.components(jw, model)
        assert I.total(w, model) == JI.total(jw, model)
    for scale in (8.0, 1.0):
        assert I.workload_scan_gbs(w.program, w.name, scale=scale) == \
            JI.workload_scan_gbs(jw.program, jw.name, scale=scale)


def test_isp_aggregates_equal():
    assert I.evaluate_all() == JI.evaluate_all()
    assert I.fig3_breakdown() == JI.fig3_breakdown()
    assert I.headline_ratios() == JI.headline_ratios()
    c = dataclasses.replace(I.IspCosts(), ssd_slowdown=2.0, rpc_us=20.0)
    jc = dataclasses.replace(JI.IspCosts(), ssd_slowdown=2.0, rpc_us=20.0)
    assert I.headline_ratios(c) == JI.headline_ratios(jc)
    with pytest.raises(ValueError):
        I.components(I.WORKLOADS[0], "nope")
    with pytest.raises(KeyError):
        I.workload_scan_gbs("embed", "nope")


# ---------------------------------------------------------------------------
# serving terms and their fitters

HORIZON = [(64, 1, 2e-3, 1e-4), (64, 8, 2e-3, 1e-4), (1000, 16, 0.0, 3e-4),
           (0, 4, 1e-3, 0.0)]
PREFIX = [(512, 256, 256, 2e-3, 1e-5), (512, 0, 128, 2e-3, 1e-5),
          (300, 600, 64, 1e-3, 2e-5), (1, 0, 1, 0.0, 1e-6)]
SPEC = [(64, 8, 0.0, 2e-3, 1e-4), (64, 8, 0.6, 2e-3, 1e-4),
        (64, 8, 1.0, 2e-3, 1e-4), (100, 4, 1.7, 0.0, 1e-4)]


def test_serving_terms_equal():
    for args in HORIZON:
        assert A.horizon_amortized_terms(*args) == \
            JA.horizon_amortized_terms(*args)
    for args in PREFIX:
        assert A.prefix_chunk_terms(*args) == JA.prefix_chunk_terms(*args)
    for args in SPEC:
        assert A.speculative_terms(*args) == JA.speculative_terms(*args)


@pytest.mark.parametrize("args", [
    (512, 2, 0.05, 256, 2, 0.02), (4096, 16, 0.4, 512, 1, 0.06),
    (100, 1, 1e-3, 300, 2, 2e-3), (512, 2, 0.05, 300, 1, 0.09)])
def test_fit_prefill_equal(args):
    assert A.fit_prefill_overheads(*args) == JA.fit_prefill_overheads(*args)


@pytest.mark.parametrize("args", [
    (1, 150.0, 8, 130.0), (1, 156.8, 8, 134.3), (1, 100.0, 8, 400.0),
    (2, 50.0, 16, 60.0)])
def test_fit_horizon_equal(args):
    assert A.fit_horizon_overheads(*args) == JA.fit_horizon_overheads(*args)


@pytest.mark.parametrize("args", [
    (8, 3.2, 200.0, 4, 2.1, 180.0), (8, 1.0, 100.0, 16, 1.0, 90.0),
    (16, 9.5, 300.0, 8, 5.0, 210.0)])
def test_fit_speculation_equal(args):
    assert A.fit_speculation_overheads(*args) == \
        JA.fit_speculation_overheads(*args)


def test_fitters_refuse_alike():
    for fn, jfn, args in (
            (A.fit_prefill_overheads, JA.fit_prefill_overheads,
             (512, 2, 0.05, 1024, 4, 0.1)),
            (A.fit_horizon_overheads, JA.fit_horizon_overheads,
             (8, 100.0, 8, 120.0)),
            (A.fit_speculation_overheads, JA.fit_speculation_overheads,
             (8, 2.0, 100.0, 8, 3.0, 120.0))):
        with pytest.raises(ValueError) as got:
            fn(*args)
        with pytest.raises(ValueError) as want:
            jfn(*args)
        assert str(got.value) == str(want.value)


def _ether(**kw):
    base = dict(control_frames=37, bytes_tx=12345, bytes_rx=6789,
                time_us=4321.5, job_frames=6, result_bytes=2048,
                retransmits=3, nacks=1, dup_frames=2, backoff_us=120.25,
                migrate_frames=4, migrate_bytes=10485760)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("stats", [
    _ether(), _ether(retransmits=0, nacks=0, dup_frames=0, backoff_us=0.0,
                     migrate_frames=0, migrate_bytes=0),
    _ether(time_us=0.0, backoff_us=0.0)])
def test_plane_terms_equal(stats):
    for n in (0, 1, 512, 4096):
        assert A.control_plane_terms(stats, n) == \
            JA.control_plane_terms(stats, n)
        assert A.data_plane_terms(stats, 384 * 2 ** 20, n) == \
            JA.data_plane_terms(stats, 384 * 2 ** 20, n)
    assert A.reliability_terms(stats) == JA.reliability_terms(stats)
    assert A.migration_terms(stats, 64) == JA.migration_terms(stats, 64)


@pytest.mark.parametrize("tier", [
    {"page_ins": 3, "page_outs": 7, "bytes_in": 3 * 2621440,
     "bytes_out": 7 * 2621440, "page_bytes": 2621440,
     "kv_bytes_moved": 10 * 2621440},
    {"bytes_in": 696320, "bytes_out": 0, "page_bytes": 696320},
    {"bytes_in": 0, "bytes_out": 0, "page_bytes": 0},
    {}])
def test_kv_tier_terms_equal(tier):
    assert A.kv_tier_terms(tier) == JA.kv_tier_terms(tier)
    hw, jhw = (dataclasses.replace(h(), flash_local_bw=2e10)
               for h in (A.HW, JA.HW))
    assert A.kv_tier_terms(tier, hw) == JA.kv_tier_terms(tier, jhw)


# ---------------------------------------------------------------------------
# the claims of tests/test_analytical.py on the port's copies


def _fig12b(pool):
    r = A.headline_ratios(pool)
    assert 6.0 <= r["d_cache_vs_h_cache"] <= 10.0
    assert 300 <= r["h_cache_vs_h_nocache"] <= 560
    assert 3400 <= r["d_cache_vs_d_nocache"] <= 6200
    assert 2300 <= r["d_cache_vs_h_nocache"] <= 4300
    assert 1.4 <= r["d_nocache_slowdown_vs_h"] <= 2.0


def _fig12a(pool):
    for name, row in pool.items():
        for config in ("H-Cache", "D-Cache"):
            dp, tp, pp = row["configs"][config]["parallelism"]
            assert tp >= pp and tp >= dp, (name, config, (dp, tp, pp))
    for name in ("gopher-280B", "turing-530B", "palm-540B", "megatron-1T"):
        dp, tp, pp = pool[name]["configs"]["H-NoCache"]["parallelism"]
        assert pp > 1, (name, (dp, tp, pp))


def _fig13a(pool):
    rl = A.seq_sensitivity("lamda-137B")
    rm = A.seq_sensitivity("megatron-1T")
    assert A.crossover_point(rl) == 256
    assert 256 <= A.crossover_point(rm) <= 2048
    assert 8.0 <= rl[-1]["speedup"] <= 12.5
    assert rl[0]["speedup"] < 1.0


def _fig13_smaller(pool):
    rl = {r["seq_len"]: r["speedup"] for r in A.seq_sensitivity("lamda-137B")}
    rm = {r["seq_len"]: r["speedup"]
          for r in A.seq_sensitivity("megatron-1T")}
    for s in (256, 512):
        assert rl[s] > rm[s], (s, rl[s], rm[s])


def _fig13cd(pool):
    sp = [r["speedup"] for r in A.batch_sensitivity("lamda-137B",
                                                    seq_len=1024)]
    assert max(sp) <= 1.6
    assert sp == sorted(sp)


def _monotonic(pool):
    m = A.POOL_LLMS[0]
    ts = [A.generation_time(m, seq_len=s, batch=16, dp=1, tp=16, pp=1,
                            cache=True, device="ssd")["total"]
          for s in (1024, 4096, 16384)]
    assert ts[0] < ts[1] < ts[2]


def _fig11(pool):
    r = I.headline_ratios()
    assert 1.4 <= r["dvirtfw_vs_pisp"] <= 1.8
    assert 1.5 <= r["dvirtfw_vs_dnaive"] <= 2.1
    assert 1.4 <= r["dvirtfw_vs_dfullos"] <= 1.8
    assert 1.1 <= r["dvirtfw_vs_host"] <= 1.5
    assert 0.10 <= r["pispv_vs_pispr"] <= 0.17
    assert 0.04 <= r["dfullos_over_pispv"] <= 0.15
    assert 0.08 <= r["dnaive_over_dfullos"] <= 0.18


def _fig3(pool):
    r = I.headline_ratios()
    assert 0.30 <= r["host_storage_share"] <= 0.46
    assert 0.35 <= r["pisp_comm_share"] <= 0.50
    assert 0.40 <= r["pisp_storage_reduction"] <= 0.60
    assert r["pisp_vs_host"] > 1.0


def _table2(pool):
    assert len(I.WORKLOADS) == 13
    by = {f"{w.program}-{w.name}": w for w in I.WORKLOADS}
    assert by["embed-rm1"].io_size_gb == 1.3
    assert by["mariadb-tpch4"].syscalls == 1.1e6
    assert by["vsftpd-fileup"].tcp_packets == 1.2e6


def _six_models(pool):
    out = I.evaluate_all()
    assert len(out) == 13
    for models in out.values():
        assert set(models) == set(I.MODELS)
        for compos in models.values():
            assert set(compos) == set(I.COMPONENTS)
            assert all(v >= 0 for v in compos.values())


def _dvirtfw_story(pool):
    w = I.WORKLOADS[0]
    d = I.components(w, "D-VirtFW")
    p = I.components(w, "P.ISP-V")
    f = I.components(w, "D-FullOS")
    assert d["LBA-set"] == 0 and d["Kernel-ctx"] == 0
    assert p["LBA-set"] > 0 and p["Kernel-ctx"] > 0
    assert d["System"] < f["System"] / 10


CLAIMS = {"fig12b_headline_ratios": _fig12b,
          "fig12a_parallelism_patterns": _fig12a,
          "fig13a_crossovers": _fig13a,
          "fig13_smaller_models_benefit_more": _fig13_smaller,
          "fig13cd_batch_sensitivity": _fig13cd,
          "generation_time_monotonic_in_seq": _monotonic,
          "fig11_headline_ratios": _fig11, "fig3_breakdown": _fig3,
          "table2_constants": _table2,
          "all_six_models_complete": _six_models,
          "dvirtfw_component_story": _dvirtfw_story}


@pytest.fixture(scope="module")
def pool_results():
    return A.evaluate_pool()


@pytest.mark.parametrize("claim", list(CLAIMS))
def test_reference_claims_hold_on_the_port(claim, pool_results):
    CLAIMS[claim](pool_results)
