"""The pool across processes: ``PoolServer(mesh=...)``, one DockerSSD node
a rank of a gloo group on the CPU, against the one-process pool, the
port's ``PagedServer`` and the JAX package's 4-device mesh pool.

Every case runs ``scripts/pool_sessions.py``'s ``pool_session`` twice on the same weights
(the reference's init of reduced granite-3-2b at 2 layers and vocab 64,
as ``tests/test_pool.py``'s setup) and prompts: in ``N`` spawned ranks
(``launch.mesh.run_ranks``: a ``FileStore`` in ``tmp_path``, no TCP port,
one thread a rank, a time limit on every join) and in this process with
``N`` nodes on one device.  Held: one rank bit-equal to ``PagedServer``;
two and four ranks' tokens equal to the one-process pool's, logits within
1e-5, every rank the same tokens and logits bit for bit; the 4-rank
logits within 1e-4 of the reference's mesh pool (one subprocess with
four forced host devices) and its tokens equal; the fused horizon,
speculative decoding, int8 / fp8 / bf16 pages, the striped policy and
chunked prefill on ranks; failover and drain complete every request
with the uninterrupted run's tokens, a drain's pages moving by
broadcast; a rank that raises or hangs fails the run within its limit;
diverged host programs are caught by ``sync_check``."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs.base import ArchConfig, get_arch  # noqa: E402
from repro_torch.launch import serve as lserve  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.core import kv_tier as tkv  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.runtime.pool import (NodeWindowStore, PoolServer,  # noqa: E402
                                      window_rows)
from repro_torch.runtime.serve import combine_partials  # noqa: E402
from repro_torch.runtime.serve import PagedServer  # noqa: E402
from repro_torch.runtime.sharding import pool_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the session harness; spawned ranks import it by name from this path
sys.path.insert(0, os.path.join(REPO, "scripts"))
from pool_sessions import pool_session, pool_sessions  # noqa: E402
GENS = [4, 6, 3, 5, 4]
TOL = 1e-5                 # ranks against one process, f32
REF_TOL = 1e-4             # against the reference's mesh pool
LIMIT = 240                # seconds, every join of spawned ranks
N_LAYERS = 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_REFERENCE = r"""
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_arch
from repro.models.api import get_model
from repro.runtime.pool import PoolServer

cfg = dataclasses.replace(get_arch("granite_3_2b").reduced(), n_layers=2,
                          vocab_size=64)
model = get_model(cfg, compute_dtype=jnp.float32, moe_no_drop=True)
params = model.init(jax.random.PRNGKey(0))
flat = {}
def walk(t, path):
    if isinstance(t, dict):
        for k, v in t.items():
            walk(v, path + [k])
    else:
        flat["/".join(path)] = np.asarray(t)
walk(jax.device_get(params), [])
np.savez(%(out)r, **flat)
rng = np.random.default_rng(0)
prompts = [rng.integers(0, cfg.vocab_size, 6, dtype=np.int32)
           for _ in range(5)]
srv = PoolServer(model, params, n_nodes=4, page_size=4,
                 hbm_pages_per_node=8, dtype=jnp.float32)
prefill = [np.asarray(srv.add_request(i, p)).tolist()
           for i, p in enumerate(prompts)]
first = {i: int(np.argmax(l)) for i, l in enumerate(prefill)}
step = {s: np.asarray(l) for s, l in srv.step(first).items()}
for s, l in step.items():
    srv.set_pending(s, int(np.argmax(l)))
rest = srv.decode(max(%(gens)r) - 2)
tokens = {s: [first[s], int(np.argmax(step[s]))] + rest[s] for s in rest}
print("RESULT " + json.dumps({
    "prompts": [p.tolist() for p in prompts], "prefill": prefill,
    "step": {s: l.tolist() for s, l in step.items()}, "tokens": tokens,
    "nodes": [srv.node_of(i) for i in range(5)]}))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's 4-node mesh pool, in one subprocess with four
    forced host devices, and its params (saved as npz)."""
    d = tmp_path_factory.mktemp("ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    code = textwrap.dedent(_REFERENCE) % {"out": str(d / "params.npz"),
                                          "gens": GENS}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")]
    res = json.loads(line[-1][len("RESULT "):])
    params = {}
    with np.load(d / "params.npz") as z:
        for key in z.files:
            node = params
            *head, leaf = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[leaf] = torch.from_numpy(np.array(z[key]))
    torch.save(params, d / "params.pt")
    res["params"] = str(d / "params.pt")
    res["tokens"] = {int(k): v for k, v in res["tokens"].items()}
    res["step"] = {int(k): v for k, v in res["step"].items()}
    return res


def _spec(reference, n, **kw):
    cfg = dataclasses.replace(get_arch("granite_3_2b").reduced(),
                              n_layers=N_LAYERS, vocab_size=64)
    spec = {"cfg": dataclasses.asdict(cfg), "params": reference["params"],
            "device": "cpu", "prompts": reference["prompts"], "gens": GENS,
            "server": {"page_size": 4, "hbm_pages_per_node": 32 // n}}
    server = kw.pop("server", {})
    spec.update(kw)
    spec["server"] = {**spec["server"], **server}
    return spec


_RUNS = {}


def _runs(reference, tmp_path_factory, name, n, **kw):
    """(the one-process pool's session, each rank's), computed once a
    case for the module."""
    if name not in _RUNS:
        spec = _spec(reference, n, **kw)
        single = pool_session(dict(spec, nodes=n))
        ranks = run_ranks(pool_session, n, (dict(spec, ranks=True),),
                          timeout_s=LIMIT,
                          workdir=str(tmp_path_factory.mktemp(name)))
        _RUNS[name] = (single, ranks)
    return _RUNS[name]


def _max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def _held(single, ranks, tol=TOL):
    """Ranks against the one-process pool: tokens equal, prefill and step
    logits within ``tol``; every rank the same, bit for bit."""
    r0 = ranks[0]
    assert r0["tokens"] == single["tokens"]
    assert _max_err(r0["prefill"], single["prefill"]) <= tol
    assert _max_err([r0["step"][s] for s in sorted(r0["step"])],
                    [single["step"][s] for s in sorted(r0["step"])]) <= tol
    for r in ranks[1:]:
        assert r["tokens"] == r0["tokens"]
        assert all(torch.equal(a, b) for a, b in zip(r["prefill"],
                                                     r0["prefill"]))
        assert all(torch.equal(r["step"][s], r0["step"][s])
                   for s in r0["step"])
    assert [r["node"] for r in ranks] == list(range(len(ranks)))


# ---------------------------------------------------------------------------
# one rank, two, four
# ---------------------------------------------------------------------------


def test_one_rank_is_paged_server(reference, tmp_path_factory):
    """A 1-rank pool is the single server bit for bit (the collectives
    over one rank are the identity): prefill and step logits, tokens."""
    single, ranks = _runs(reference, tmp_path_factory, "one", 1)
    spec = _spec(reference, 1)
    model = get_model(ArchConfig(**spec["cfg"]), moe_no_drop=True)
    params = torch.load(spec["params"], weights_only=False)
    ref = PagedServer(model, params, page_size=4, hbm_pages=32,
                      device="cpu")
    prefill = [ref.add_request(i, np.asarray(p, np.int32))
               for i, p in enumerate(spec["prompts"])]
    first = {i: int(lg.argmax()) for i, lg in enumerate(prefill)}
    step = ref.step(first)
    for s, lg in step.items():
        ref.set_pending(s, int(lg.argmax()))
    rest = ref.decode(max(GENS) - 2)
    tokens = {s: [first[s], int(step[s].argmax())] + rest[s] for s in rest}
    r0 = ranks[0]
    assert all(torch.equal(a, b) for a, b in zip(r0["prefill"], prefill))
    assert all(torch.equal(r0["step"][s], step[s]) for s in step)
    assert r0["tokens"] == tokens == single["tokens"]


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_match_one_process_pool(reference, tmp_path_factory, n):
    single, ranks = _runs(reference, tmp_path_factory, f"n{n}", n)
    _held(single, ranks)


def test_four_ranks_match_reference_mesh_pool(reference, tmp_path_factory):
    """Four ranks against the JAX package's 4-device mesh pool: the same
    tokens, logits within 1e-4."""
    _, ranks = _runs(reference, tmp_path_factory, "n4", 4)
    r0 = ranks[0]
    want = [torch.tensor(x) for x in reference["prefill"]]
    assert _max_err(r0["prefill"], want) <= REF_TOL
    assert _max_err([r0["step"][s] for s in sorted(r0["step"])],
                    [torch.tensor(reference["step"][s])
                     for s in sorted(r0["step"])]) <= REF_TOL
    assert r0["tokens"] == reference["tokens"]


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_a_decode_step(reference, tmp_path_factory, n):
    """Two all-reduces a layer a step (MAX of m, then one SUM of l and
    acc), with the digest checks; their bytes; no broadcast."""
    _, ranks = _runs(reference, tmp_path_factory, f"n{n}", n)
    cfg = get_arch("granite_3_2b").reduced()
    for r in ranks:
        c = r["collectives"]
        steps = max(GENS) - 2             # decode(max(GENS) - 2), per token
        checks = 1                        # at decode's end (< 16 steps)
        assert c["all_reduce"] == 2 * N_LAYERS * steps + checks
        b = len(GENS)
        # a batch bucketed to 8 rows, H heads: m, l [8, H], acc [8, H, D]
        per_layer = 4 * 8 * cfg.n_heads * (2 + cfg.hd)
        assert c["all_reduce_bytes"] == (N_LAYERS * steps * per_layer +
                                         16 * checks)
        assert c["broadcast"] == 0 and b == 5


# ---------------------------------------------------------------------------
# the other routes on four ranks
# ---------------------------------------------------------------------------

VARIANTS = {
    "h8": {"horizon": 8},
    "speculative": {"horizon": 8, "speculative": True},
    "int8": {"server": {"page_dtype": "int8"}},
    "fp8": {"server": {"page_dtype": "fp8"}},
    "bf16": {"server": {"dtype": "bfloat16"}},
    "striped": {"server": {"policy": "striped"}},
    "chunked": {"chunk": 4},
    # an elastic pool of bucket 4 with 2 active: ranks 2 and 3 parked,
    # joining every collective and owning nothing
    "parked": {"server": {"active": 2, "hbm_pages_per_node": 16}},
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_four_rank_variants_match_one_process(reference, tmp_path_factory,
                                              name):
    single, ranks = _runs(reference, tmp_path_factory, name, 4,
                          **VARIANTS[name])
    _held(single, ranks)


def test_horizon_and_speculative_tokens_are_per_token(reference,
                                                      tmp_path_factory):
    """On ranks the fused horizon and speculative decoding give the
    per-token path's greedy tokens."""
    base = _runs(reference, tmp_path_factory, "n4", 4)[1][0]["tokens"]
    for name in ("h8", "speculative"):
        got = _runs(reference, tmp_path_factory, name, 4,
                    **VARIANTS[name])[1][0]["tokens"]
        assert got == base, name


# ---------------------------------------------------------------------------
# failover and drain
# ---------------------------------------------------------------------------


def test_failover_completes_every_request(reference, tmp_path_factory):
    """Node 1 killed after two router steps: its sequences requeue
    through the router and finish on the survivors, on every rank, with
    the uninterrupted run's tokens."""
    single, ranks = _runs(reference, tmp_path_factory, "failover", 4,
                          kind="failover", fail=1,
                          server={"hbm_pages_per_node": 8})
    want = {i: reference["tokens"][i][:g] for i, g in enumerate(GENS)}
    for r in ranks:
        assert r["tokens"] == want == single["tokens"]
        assert r["requeues"] >= 1 and 1 not in r["alive"]
        assert r["requeues"] == single["requeues"]


def test_drain_moves_pages_by_broadcast(reference, tmp_path_factory):
    """Node 2 drained after two decode tokens: its pages move to the
    survivors by broadcast from its rank, every request keeps decoding,
    and the tokens equal the undrained run's."""
    single, ranks = _runs(reference, tmp_path_factory, "drain", 4,
                          kind="drain", drain=2)
    base = _runs(reference, tmp_path_factory, "n4", 4)[1][0]["tokens"]
    r0 = ranks[0]
    assert r0["drain"]["migrated_pages"] > 0 and not r0["drain"]["cold"]
    assert r0["drain"] == single["drain"]
    for r in ranks:
        assert r["tokens"] == base == single["tokens"]
        # every moved stacked page: k and v, one broadcast each
        assert r["collectives"]["broadcast"] == \
            2 * r0["drain"]["migrated_pages"]
        assert r["collectives"]["broadcast_bytes"] > 0


# ---------------------------------------------------------------------------
# failures fail, within their limit
# ---------------------------------------------------------------------------


def _raise_on_rank_one():
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(120)                 # rank 0 would wait far past the test
    return dist.get_rank()


def _hang_on_rank_one():
    if dist.get_rank() == 1:
        time.sleep(120)
    dist.barrier()
    return dist.get_rank()


def _diverge(spec):
    """A 2-rank pool whose rank 1 places one sequence elsewhere: the
    digest check must raise."""
    mesh = pool_mesh(2, device_type="cpu")
    model = get_model(ArchConfig(**spec["cfg"]))
    params = torch.load(spec["params"], weights_only=False)
    srv = PoolServer(model, params, mesh=mesh, device="cpu", page_size=4,
                     hbm_pages_per_node=16)
    srv.add_request(0, np.asarray(spec["prompts"][0], np.int32),
                    node=dist.get_rank())
    srv.sync_check()
    return "not caught"


def test_a_raising_rank_fails_the_run(tmp_path):
    """Rank 1 raises while rank 0 would go on for two minutes: the run
    raises rank 1's error at once and ends rank 0."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        run_ranks(_raise_on_rank_one, 2, timeout_s=LIMIT,
                  workdir=str(tmp_path))
    assert time.monotonic() - t0 < 60


def test_a_hanging_rank_times_out(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not end within 15 s"):
        run_ranks(_hang_on_rank_one, 2, timeout_s=15, workdir=str(tmp_path))
    assert time.monotonic() - t0 < 60


def test_sync_check_catches_diverged_ranks(reference, tmp_path):
    with pytest.raises(Exception, match="pool ranks diverged"):
        run_ranks(_diverge, 2, (_spec(reference, 2),), timeout_s=LIMIT,
                  workdir=str(tmp_path))


# ---------------------------------------------------------------------------
# the launcher and the pieces
# ---------------------------------------------------------------------------


def _launcher(nodes):
    try:
        return lserve.main(["--arch", "granite-3-2b", "--reduced", "--pool",
                            "--nodes", str(nodes), "--requests", "4",
                            "--prompt-len", "8", "--gen", "5", "--page-size",
                            "4", "--hbm-pages", "16", "--device", "cpu"])
    except SystemExit as e:                  # carry the launcher's message
        raise RuntimeError(str(e)) from None


def test_launcher_serves_one_node_a_rank(tmp_path, capsys):
    """``launch.serve --pool`` in joined ranks serves one node a rank: the
    same outputs as the one-process run of the same command."""
    ranks = run_ranks(_launcher, 2, (2,), timeout_s=LIMIT,
                      workdir=str(tmp_path))
    assert ranks[0] == ranks[1] == _launcher(2)
    with pytest.raises(Exception, match="serves one node a rank"):
        run_ranks(_launcher, 2, (4,), timeout_s=LIMIT,
                  workdir=str(tmp_path / "bad"))


def test_window_store_maps_global_ids():
    """``NodeWindowStore``: node 1 of 3 windows of 4 pages holds pages
    4..7; other ids go to the local sentinel; appends land only in its
    window; a page read and written back on its own node round-trips."""
    st = NodeWindowStore(node=1, n_nodes=3, n_local=4, group=None,
                         stats={}, n_layers=2, page_size=2, n_kv_heads=1,
                         head_dim=4, device="cpu")
    assert st.hbm_pages == 12 and st.base == 4
    rows = torch.tensor([0, 3, 4, 7, 8, 12])
    assert st.local_rows(rows).tolist() == [4, 4, 0, 3, 4, 4]
    k = torch.arange(6 * 4, dtype=torch.float32).view(6, 1, 4)
    st.append(0, rows, torch.zeros(6, dtype=torch.long), k, -k)
    win = st.layer_state(0)["k"]
    assert torch.equal(win[0, 0, 0], k[2, 0]) and torch.equal(
        win[3, 0, 0], k[3, 0])
    assert win[1:3].abs().sum() == 0
    node, data = st.read_page(5)
    assert node == 1 and data is not None
    assert st.read_page(9) == (2, None)
    st.write_page(6, node, data)
    assert torch.equal(st.layer_state(0)["k"][2], st.layer_state(0)["k"][1])
    st.copy_page(4, 7)
    assert torch.equal(st.layer_state(0)["k"][3], st.layer_state(0)["k"][0])


def test_mesh_needs_a_model_axis():
    class Mesh:
        mesh_dim_names = ("data",)
    spec_cfg = get_arch("granite_3_2b").reduced()
    model = get_model(spec_cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="needs a 'model' axis"):
        PoolServer(model, params, mesh=Mesh(), device="cpu")


@pytest.mark.parametrize("ranks,kw,match", [
    (2, {"n_nodes": 4}, "n_nodes=4 over a pool mesh of 2 ranks"),
    (3, {"active": 2}, "pow2 bucket, got 3 ranks"),
])
def test_mesh_refuses_a_pool_of_another_size(ranks, kw, match):
    """With a mesh the pool is one node a rank: an ``n_nodes`` other than
    the mesh's ranks raises, and an elastic pool needs a mesh of its pow2
    bucket (without a mesh, ``active=`` sizes the pool up to it)."""
    class Mesh:
        mesh_dim_names = ("model",)

        def size(self, dim):
            return ranks
    model = get_model(get_arch("granite_3_2b").reduced())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match=match):
        PoolServer(model, params, mesh=Mesh(), device="cpu", **kw)


def _window_inputs(policy, page_dtype, seed=3, n=4, p=6, page=4):
    """q, global pages (with scales when coded) and a global table over
    ``n`` windows of ``p`` pages, rows placed (row i in window i % n) or
    striped (page j in window j % n), lengths ragged with a padding row."""
    rng = np.random.default_rng(seed)
    lengths = [0, 1, 5, 13, 24, 19]
    b, h, hkv, d, pps = len(lengths), 8, 2, 16, 6
    q = torch.from_numpy(rng.standard_normal((b, h, d), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((n * p, page, hkv, d),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((n * p, page, hkv, d),
                                             dtype=np.float32))
    table = np.zeros((b, pps), np.int32)
    for i, ln in enumerate(lengths):
        for j in range(-(-ln // page)):
            node = i % n if policy == "placed" else j % n
            table[i, j] = node * p + rng.integers(p)
    ks = vs = None
    if page_dtype != "fp32":
        code, qmax = tkv._CODE[page_dtype]
        k, ks = tkv.quantize_page_kv(k, qmax, code)
        v, vs = tkv.quantize_page_kv(v, qmax, code)
    return (q, k, v, ks, vs, torch.from_numpy(table),
            torch.tensor(lengths, dtype=torch.int32), n, p)


@pytest.mark.parametrize("page_dtype", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("policy", ["placed", "striped"])
@pytest.mark.parametrize("form", ["decode", "chunk"])
def test_window_partials_are_the_global_node_partials(page_dtype, policy,
                                                      form):
    """The rank route's one rule: node r's pool form over its own window
    (one node of ``p`` pages, the table through ``window_rows``) gives
    node r's partials of the global pool form over all ``n`` windows,
    bit for bit (the plain versions here; ``tests/test_torch_card.py``
    holds the kernels); merged across the nodes it is the global pool
    wrapper's output (1e-6)."""
    q, k, v, ks, vs, table, lengths, n, p = _window_inputs(policy,
                                                           page_dtype)
    if form == "chunk":                  # one row expanded over the batch
        table = table[4:5].expand(table.shape)
        lengths = torch.arange(1, table.shape[0] + 1,
                               dtype=torch.int32) + 13
    acc, m, l = ops.pool_partials(q, k, v, table, lengths, ks, vs,
                                  n_nodes=n, n_local=p)
    nodes = []
    for r in range(n):
        sl = slice(r * p, (r + 1) * p)
        win = window_rows(table, r, p)
        if form == "chunk":
            win = window_rows(table[0], r, p)[None].expand(table.shape)
        got = ops.pool_partials(q, k[sl], v[sl], win, lengths,
                                None if ks is None else ks[sl],
                                None if vs is None else vs[sl],
                                n_nodes=1, n_local=p)
        want = (acc[:, :, r:r + 1], m[:, :, r:r + 1], l[:, :, r:r + 1])
        for a, w in zip(got, want):
            assert torch.equal(a, w)
        nodes.append(ref.merge_split_partials(got[0][:, :, 0],
                                              got[1][:, :, 0],
                                              got[2][:, :, 0]))
    merged = combine_partials(*(torch.stack(x) for x in zip(*nodes)))
    whole = (ops.paged_attention_pool(q, k, v, table, lengths, n_nodes=n,
                                      n_local=p) if ks is None else
             ops.paged_attention_pool_q8(q, k, v, ks, vs, table, lengths,
                                         n_nodes=n, n_local=p))
    assert float((merged - whole).abs().max()) <= 1e-6


def test_one_spawn_serves_pools_of_one_two_four(reference,
                                                tmp_path_factory):
    """``pool_sessions`` (what ``chip_smoke.py`` spawns): one spawn of four
    ranks serves pools over its first 1, 2 and 4 ranks in turn, the idle
    ranks waiting; each pool's tokens and logits are the separate
    spawns'."""
    specs = [dict(_spec(reference, n), ranks=n) for n in (1, 2, 4)]
    got = run_ranks(pool_sessions, 4, (specs,), timeout_s=LIMIT,
                    workdir=str(tmp_path_factory.mktemp("sessions")))
    for i, n in enumerate((1, 2, 4)):
        _, ranks = _runs(reference, tmp_path_factory,
                         "one" if n == 1 else f"n{n}", n)
        for r in range(4):
            res = got[r][i]
            if r >= n:
                assert res is None
                continue
            assert res["tokens"] == ranks[r]["tokens"]
            assert all(torch.equal(a, b) for a, b in
                       zip(res["prefill"], ranks[r]["prefill"]))
