"""The port's in-storage analytics path (CPU) against the JAX package's:
ExtentStore allocation and byte counts, AnalyticsJob JSON, JOB/READ
frames on a StoragePool, the offload planner's estimates and choices,
and the Ether-oN counters of the same job sequence."""
import json
import sys
import urllib.parse

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import AnalyticsJob as JJob  # noqa: E402
from repro.core import ExtentStore as JStore  # noqa: E402
from repro.core import StoragePool as JPool  # noqa: E402
from repro.core import analytics_blob as jblob  # noqa: E402
from repro.core import from_jsonable as jfrom  # noqa: E402
from repro.runtime.offload import OffloadPlanner as JPlanner  # noqa: E402
from repro_torch.core.container import ContainerError, from_jsonable  # noqa: E402
from repro_torch.core.extent_store import (AnalyticsJob, ExtentStore,  # noqa: E402
                                           ExtentStoreError, analytics_blob,
                                           project)
from repro_torch.core.lambda_fs import SHARABLE_NS  # noqa: E402
from repro_torch.core.storage_pool import StoragePool  # noqa: E402
from repro_torch.runtime.offload import OffloadPlanner  # noqa: E402

EXT_CFG = {"n_pages": 16, "page_rows": 8, "n_cols": 16}
SUM_TOL = 1e-5        # the JAX package's in-page jnp.sum has no fixed order


def _stores(page_dtype="fp32"):
    return (JStore(**EXT_CFG, page_dtype=page_dtype),
            ExtentStore(**EXT_CFG, page_dtype=page_dtype, device="cpu"))


def _pools(n=2, page_dtype="fp32"):
    cfg = {**EXT_CFG, "page_dtype": page_dtype}
    jp, tp = JPool(n, extent_cfg=cfg), StoragePool(
        n, extent_cfg={**cfg, "device": "cpu"})
    jp.broadcast_pull("isp-analytics", jblob())
    tp.broadcast_pull("isp-analytics", analytics_blob())
    return jp, tp


def _ingest(pool, name, data, node=0):
    """Host drops the table in the sharable namespace; the node ingests
    it through λFS (counted syscalls)."""
    ip = pool.alive_nodes()[node]
    n = pool.nodes[ip]
    n.fs.write(f"/data/{name}.bin", data.tobytes(), SHARABLE_NS,
               actor="host")
    n.ingest_extent(name, f"/data/{name}.bin", data.shape[1])
    return ip


@pytest.mark.parametrize("page_dtype", ["fp32", "int8", "fp8"])
def test_extent_store_roundtrip_matches_jax(page_dtype):
    js, ts = _stores(page_dtype)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(20, 16)).astype(np.float32)
    b = rng.normal(size=(5, 10)).astype(np.float32)          # narrow
    for s in (js, ts):
        s.put("a", a)
        s.put("b", b)
    for name in ("a", "b"):
        assert ts.extents[name].page_ids == js.extents[name].page_ids
        assert ts.extents[name].nbytes == js.extents[name].nbytes
        np.testing.assert_array_equal(ts.get(name), js.get(name))
        codes, scales = ts.raw_extent(name)
        jcodes, jscales = js.raw_extent(name)
        np.testing.assert_array_equal(codes, jcodes.view(codes.dtype))
        if scales is not None:
            np.testing.assert_array_equal(scales, jscales)
    assert ts.row_nbytes == js.row_nbytes and \
        ts.page_nbytes == js.page_nbytes
    assert ts.extents["a"].nbytes == 20 * (16 * {"fp32": 4, "int8": 1,
                                                 "fp8": 1}[page_dtype] +
                                           (page_dtype != "fp32") * 4)
    np.testing.assert_array_equal(
        ts.page_table("a").numpy(), np.asarray(js.page_table("a")))
    assert ts.page_table("a").dtype == torch.int32
    for s in (js, ts):
        s.drop("a")
        s.put("c", a)                  # reuses the freed pages, in order
    assert ts.extents["c"].page_ids == js.extents["c"].page_ids
    assert ts.free_pages() == js.free_pages()


def test_extent_store_enospc_and_shape_errors():
    _, ts = _stores()
    for bad in (np.zeros((17 * 8, 16), np.float32),       # ENOSPC
                np.zeros((4, 17), np.float32),            # too wide
                np.zeros((8,), np.float32)):              # not 2-D
        with pytest.raises(ExtentStoreError):
            ts.put("x", bad)
    ts.put("x", np.ones((3, 4), np.float32))
    with pytest.raises(ExtentStoreError):
        ts.put("x", np.ones((3, 4), np.float32))          # duplicate
    with pytest.raises(ExtentStoreError):
        ts.get("missing")
    with pytest.raises(ValueError):
        ExtentStore(page_dtype="bf16", device="cpu")


def test_analytics_job_json_roundtrip_and_validation():
    job = AnalyticsJob(extent="t", reduce="topk", query=[1.0, 2.0], k=3,
                       metric="cosine", job_id=7)
    d = json.loads(json.dumps(job.to_dict()))
    assert AnalyticsJob.from_dict(d) == job
    assert d == JJob(extent="t", reduce="topk", query=[1.0, 2.0], k=3,
                     metric="cosine", job_id=7).to_dict()
    np.testing.assert_array_equal(job.padded_query(4), [1, 2, 0, 0])
    for bad in ({"filter_op": "gt"}, {"reduce": "median"},
                {"reduce": "topk", "k": 3},
                {"reduce": "topk", "query": [1.0], "k": 0},
                {"reduce": "topk", "query": [1.0], "k": 1, "metric": "l2"},
                {"query": [1.0]}):
        with pytest.raises(ContainerError):
            AnalyticsJob.from_dict({"extent": "t", **bad})
    block = np.zeros((8, 4), np.float32)
    block[0], block[1, 2], block[2, 2], block[3, 2] = 4, 10, -1, 5
    for reduce, want in (("count", 4.0), ("sum", 10.0), ("min", -1.0),
                         ("max", 5.0), ("avg", 2.5)):
        assert project(block, AnalyticsJob("t", reduce=reduce,
                                           reduce_col=2)) == want


def _job_sequence():
    rng = np.random.default_rng(1)
    q = [float(x) for x in rng.normal(size=16)]
    return [JJob(extent="t0", filter_col=2, filter_op="ge", job_id=0),
            JJob(extent="t0", filter_col=1, filter_op="eq", threshold=1.0,
                 reduce="count", job_id=1),
            JJob(extent="t1", filter_col=0, filter_op="lt", threshold=0.5,
                 reduce="sum", reduce_col=3, job_id=2),
            JJob(extent="t1", reduce="topk", query=q, k=5, job_id=3),
            JJob(extent="t0", reduce="topk", query=q[:9], k=40,
                 metric="cosine", job_id=4)]


@pytest.mark.parametrize("page_dtype", ["fp32", "int8", "fp8"])
def test_planner_runs_match_jax_and_host(page_dtype):
    jp, tp = _pools(page_dtype=page_dtype)
    rng = np.random.default_rng(2)
    t0 = rng.normal(size=(50, 16)).astype(np.float32)
    t0[:, 1] = np.round(t0[:, 1])
    t1 = rng.normal(size=(30, 12)).astype(np.float32)
    for pool in (jp, tp):
        _ingest(pool, "t0", t0, node=0)
        _ingest(pool, "t1", t1, node=1)
    jjobs = _job_sequence()
    tjobs = [AnalyticsJob(**j.to_dict()) for j in jjobs]
    jplan, tplan = JPlanner(jp), OffloadPlanner(tp)
    for je, te in zip(jplan.plan(jjobs), tplan.plan(tjobs)):
        assert (te.node_ip, te.bytes_scanned, te.result_bytes, te.host_s,
                te.dvirtfw_s, te.choice) == (
            je.node_ip, je.bytes_scanned, je.result_bytes, je.host_s,
            je.dvirtfw_s, je.choice)
    recs = {}
    for force in (None, "device", "host"):
        recs[force] = (jplan.execute(jjobs, force=force),
                       tplan.execute(tjobs, force=force))
        for jr, tr in zip(*recs[force]):
            assert tr["where"] == jr["where"]
            if jr["job"].reduce == "topk":
                np.testing.assert_array_equal(tr["block"][1],
                                              jr["block"][1])
                np.testing.assert_allclose(tr["block"][0], jr["block"][0],
                                           rtol=1e-6, atol=0)
            else:
                b, w = tr["block"], jr["block"]
                np.testing.assert_array_equal(b[[0, 2, 3]], w[[0, 2, 3]])
                np.testing.assert_allclose(b[1], w[1], rtol=SUM_TOL,
                                           atol=SUM_TOL)
    # the port's in-storage blocks equal its host folds, bit for bit
    for dr, hr in zip(recs["device"][1], recs["host"][1]):
        assert dr["where"] == "device" and hr["where"] == "host"
        np.testing.assert_array_equal(dr["block"], hr["block"])
    # the same frames, the same bytes, the same accounted time
    assert vars(tp.driver.stats) == vars(jp.driver.stats)
    assert tp.driver.stats.job_frames >= 2 and \
        tp.driver.stats.extent_reads >= len(tjobs)


def test_front_door_and_container_lifecycle_match_jax():
    jp, tp = _pools(1)
    data = np.random.default_rng(3).normal(size=(20, 16)).astype(np.float32)
    job = json.dumps([JJob(extent="t", filter_col=3, filter_op="ge",
                           reduce="count").to_dict()])
    out = []
    for pool, decode in ((jp, jfrom), (tp, from_jsonable)):
        ip = _ingest(pool, "t", data)
        d = pool.nodes[ip].docker
        cid = json.loads(d.handle_http(
            "POST /containers/create?image=isp-analytics"))["Id"]
        resp = decode(json.loads(d.handle_http(
            f"POST /containers/{cid}/start?job={urllib.parse.quote(job)}")))
        bad = json.loads(d.handle_http("POST /containers/99/start"))
        out.append((resp["result"][0], d.cmd_ps(), bad["status"],
                    d.cmd_logs(cid)))
    (jb, jps, jbad, jlog), (tb, tps, tbad, tlog) = out
    np.testing.assert_array_equal(tb[[0, 2, 3]], jb[[0, 2, 3]])
    assert tb[0, 0] == (data[:, 3] >= 0).sum()
    assert tps == jps and tbad == jbad == 400 and tlog == jlog


def test_job_frame_errors_surface_and_release_resources():
    _, tp = _pools(1)
    ip = tp.alive_nodes()[0]
    node = tp.nodes[ip]
    node.extents.put("t", np.ones((8, 16), np.float32))
    job = AnalyticsJob(extent="t").to_dict()
    tp.driver.submit_jobs(ip, [job])
    before = (len(node.docker.cmd_ps()), len(node.fw.pools.isp_pool),
              node.fs.used)
    for _ in range(3):
        tp.driver.submit_jobs(ip, [job])
    assert (len(node.docker.cmd_ps()), len(node.fw.pools.isp_pool),
            node.fs.used) == before
    from repro_torch.core.ether_on import EtherONError
    with pytest.raises(EtherONError, match="no extent"):
        tp.driver.submit_jobs(ip, [AnalyticsJob(extent="nope").to_dict()])


def test_fp8_extent_fetched_without_ml_dtypes(monkeypatch):
    jp, tp = _pools(1, page_dtype="fp8")
    data = np.random.default_rng(4).normal(size=(19, 16)).astype(np.float32)
    jip, tip = _ingest(jp, "t", data), _ingest(tp, "t", data)
    want = jp.driver.fetch_extent(jip, "t")
    # any attempt to import ml_dtypes now fails
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    got = tp.driver.fetch_extent(tip, "t")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tp.nodes[tip].extents.get("t"))
    assert vars(tp.driver.stats) == vars(jp.driver.stats)


def test_pool_membership_and_serving_hooks_not_ported():
    _, tp = _pools(3)
    tp.nodes[tp.alive_nodes()[0]].extents.put("e", np.ones((4, 4),
                                                           np.float32))
    tp.nodes[tp.alive_nodes()[1]].extents.put("e", np.ones((4, 4),
                                                           np.float32))
    first = tp.alive_nodes()[0]
    assert tp.locate_replicas("e") == tp.alive_nodes()[:2]
    tp.place_independent("job", "isp-analytics", n=1)
    tp.mark_unreachable(first)
    assert tp.locate_extent("e") == tp.alive_nodes()[0] != first
    assert tp.placements["job"].node_ips != [first]
    assert ("unreachable", first) in tp.events
    tp.scale_to(4)
    assert len(tp.alive_nodes()) == 3 and len(tp.nodes) == 4
    # the serving hooks are ported now: a fault plan attaches to the
    # fabric, and a planner takes a router (without an attached server
    # every node admits analytics)
    from repro_torch.core.faults import FaultPlan
    inj = tp.attach_faults(FaultPlan())
    assert tp.fault_injector is inj and tp.driver.faults is inj
    planner = OffloadPlanner(tp, router=object())
    assert all(planner._node_admits(ip) for ip in tp.alive_nodes())
