"""RWKV6, Zamba2 and the MoE transformer over a ``(data, model)`` mesh of
ranks, and the expert-parallel MoE (``layers.apply_moe_shardmap``),
against the JAX package on the same numpy inputs.

Reduced rwkv6-3b (2 layers, d 64, 4 heads of 16), zamba2-1.2b (4 layers,
8 SSM heads of 16, the shared block's 4 heads applied twice) and
phi3.5-moe (2 layers, 4 experts, top-2, capacity factor 0.25 so that
tokens drop), the reference's init carried to the ranks as numpy.  The
one-process references run here (the reference's GSPMD result over a
mesh is its one-process one); the reference's ``apply_moe_shardmap``
runs once in a subprocess with four forced host devices on a ``(2, 2)``
mesh.  The port runs in one spawn of 4 gloo ranks
(``scripts/mesh_sessions.py``), the restores in one spawn of 2, every
join limited to ``LIMIT`` s.  Held: loss 1e-5 rel, the pre-clip
grad_norm 1e-4 rel, gradients 1e-4 x max(1, max|g|), params by
``mesh_sessions.step_check`` (band 10: elements whose reference
gradient is within 10 eps of zero take the bound GRAD_TOL implies, as
the smoke's mesh phase; zamba2's in_proj and the MoE's attention wv
each have one at 1.2-1.5 eps); decode logits within 1e-4 of the
reference's, greedy tokens identical, the cache gathered whole equal to
the reference's (1e-4); grad-accum 2 (remat full) against one process;
the shardmap MoE against the reference's with and without ``no_drop``,
and on ``(1, 4)`` the dense impl's routing; restores onto ``(1, 2)`` and
``(2, 1)``; heads that do not split raise."""
import dataclasses
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
from repro.data.pipeline import synthetic_stream  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import clip_by_global_norm as jclip  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from mesh_sessions import (LOGIT_TOL, LOSS_RTOL, grads_check,  # noqa: E402
                           mesh_sessions, step_check)

LIMIT = 240                # seconds, every join of spawned ranks
MESHES = [(2, 2), (1, 4)]
LR = 1e-3
B, PROMPT, CACHE, GEN = 4, 16, 24, 6
ARCHS = {"rwkv6": "rwkv6_3b", "zamba2": "zamba2_1_2b",
         "moe": "phi3_5_moe_42b_a6_6b"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(shape):
    return "x".join(map(str, shape))


def _jcfg(name):
    cfg = jget_arch(ARCHS[name]).reduced()
    if name == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=0.25)
    if name == "zamba2":                   # two applications of the block
        cfg = dataclasses.replace(cfg, n_layers=4)
    return cfg


def _reference(name):
    """The JAX package's one-process run: one train step (loss, its
    pre-clip norm, the clipped gradients fed to AdamW, params), a prefill
    of ``PROMPT`` tokens, ``GEN`` greedy decode steps (a KV cache padded
    to ``CACHE`` positions), the cache after them; the numpy inputs."""
    jcfg = _jcfg(name)
    jm = jget_model(jcfg, compute_dtype=jnp.float32, remat="none")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    batch = synthetic_stream(0, 0, 0, batch=8, seq_len=16,
                             vocab=jcfg.vocab_size, kind="learnable")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init, upd = jadamw(lr=LR)
    # the reference's step, its gradient computed once
    loss, g = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb)[0]))(jp)

    @jax.jit
    def update(g, p):
        g, norm = jclip(g, 1.0)
        return g, norm, upd(g, init(p), p)[0]
    g, norm, p1 = update(g, jp)
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, PROMPT), dtype=np.int32)
    logits, cache = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t}, cache_dtype=jnp.float32))(jp, jnp.asarray(prompts))
    if "k" in cache:
        pad = [(0, 0)] * 3 + [(0, CACHE - PROMPT), (0, 0)]
        cache = {**cache, **{n: jnp.pad(cache[n], pad) for n in ("k", "v")}}
    step = jax.jit(jm.decode_step)
    toks, steps = [np.asarray(logits.argmax(-1))], []
    for _ in range(GEN):
        lg, cache = step(jp, cache, jnp.asarray(toks[-1]))
        steps.append(np.asarray(lg))
        toks.append(np.asarray(lg.argmax(-1)))
    return {"cfg": jcfg, "params": jax.device_get(jp), "batch": batch,
            "loss": float(loss), "grad_norm": float(norm),
            "grads": jax.device_get(g), "step": jax.device_get(p1),
            "prompts": prompts, "prefill": np.asarray(logits),
            "steps": steps, "tokens": np.stack(toks, 1),
            "cache": {k: np.asarray(v) for k, v in cache.items()
                      if k != "index"}}


@pytest.fixture(scope="module")
def refs():
    return {name: _reference(name) for name in ARCHS}


_SHARDMAP = """
import json
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.launch.mesh import auto_axis_kwargs
from repro.configs.base import get_arch
from repro.models.api import get_model
from repro.optim import clip_by_global_norm
from repro.runtime import sharding as shd

cfg = dataclasses.replace(get_arch("phi3_5_moe_42b_a6_6b").reduced(),
                          capacity_factor=0.25)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     **auto_axis_kwargs(("data", "model")))
z = np.load(%(inp)r)
params = {}
for key in z.files:
    if key.startswith("params/"):
        node = params
        *head, leaf = key[len("params/"):].split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(z[key])
batch = {"tokens": jnp.asarray(z["tokens"]), "labels": jnp.asarray(z["labels"])}
pshard = jax.tree.map(lambda sp: NamedSharding(mesh, sp),
                      shd.param_specs(mesh, params))
out, losses = {}, {}
for no_drop in (False, True):
    m = get_model(cfg, compute_dtype=jnp.float32, remat="none",
                  moe_no_drop=no_drop, moe_impl="shardmap")
    with mesh:
        loss, g = jax.jit(jax.value_and_grad(lambda p: m.loss(p, batch)[0]),
                          in_shardings=(pshard,))(params)
    g, norm = clip_by_global_norm(g, 1.0)
    name = "nodrop" if no_drop else "drop"
    losses[name] = [float(loss), float(norm)]
    for path, x in jax.tree_util.tree_flatten_with_path(g)[0]:
        out[name + "/" + "/".join(k.key for k in path)] = np.asarray(x)
np.savez(%(out)r, **out)
print("RESULT " + json.dumps(losses))
"""


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def _tree(z, prefix):
    tree = {}
    for key in z.files:
        if key.startswith(prefix + "/"):
            node = tree
            *head, leaf = key[len(prefix) + 1:].split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[leaf] = np.array(z[key])
    return tree


@pytest.fixture(scope="module")
def shardmap_ref(refs, tmp_path_factory):
    """The reference's shardmap MoE on a (2, 2) mesh: loss, pre-clip norm
    and clipped gradients, with and without ``no_drop``."""
    import json

    d = tmp_path_factory.mktemp("smap")
    r = refs["moe"]
    np.savez(d / "in.npz", **{"params/" + k: v for k, v in
                              _flat(r["params"]).items()},
             tokens=r["batch"]["tokens"], labels=r["batch"]["labels"])
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    code = textwrap.dedent(_SHARDMAP) % {"inp": str(d / "in.npz"),
                                         "out": str(d / "out.npz")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")]
    res = {"losses": json.loads(line[-1][len("RESULT "):])}
    with np.load(d / "out.npz") as z:
        for name in ("drop", "nodrop"):
            res[name] = _tree(z, name)
    return res


def _spec(r, kind, mesh, **kw):
    return {"kind": kind, "cfg": dataclasses.asdict(r["cfg"]),
            "params": r["params"], "mesh": mesh, **kw}


def _bad_cfgs():
    """Configs whose heads do not split over 4: rwkv6 at d 48 (3 heads),
    zamba2 with 6 SSM heads (head dim 32 over d_inner 192) and with 6
    attention heads."""
    rw = get_arch("rwkv6-3b").reduced()
    zb = get_arch("zamba2-1.2b").reduced()
    return [dataclasses.asdict(c) for c in (
        dataclasses.replace(rw, d_model=48),
        dataclasses.replace(zb, d_model=96, ssm_head_dim=32),
        dataclasses.replace(zb, d_model=96, n_heads=6, n_kv_heads=6))]


@pytest.fixture(scope="module")
def ranks(refs, shardmap_ref, tmp_path_factory):
    """Every (2, 2) and (1, 4) case in one spawn of 4 ranks."""
    del shardmap_ref                       # its subprocess first
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    cases = {}
    for name, r in refs.items():
        for mesh in MESHES:
            m = _ids(mesh)
            cases[f"{name} train {m}"] = _spec(r, "train", mesh,
                                               batches=[r["batch"]], lr=LR,
                                               keep=True)
            cases[f"{name} serve {m}"] = _spec(
                r, "serve", mesh, kv="f32", prompts=r["prompts"],
                cache_len=CACHE, gen=GEN, keep_cache=True)
        # step_band: elements whose one-process gradient is within 10 eps
        # take the bound GRAD_TOL implies (mesh_sessions.step_check;
        # zamba2's in_proj has one at 1.15 eps)
        cases[f"{name} ga2 2x2"] = _spec(r, "train", (2, 2),
                                         batches=[r["batch"]], lr=LR,
                                         ga=2, remat="full", twin=True,
                                         step_band=10)
        cases[f"{name} save 2x2"] = _spec(r, "save", (2, 2),
                                          dir=os.path.join(ckpt, name))
    moe = refs["moe"]
    for no_drop in (False, True):
        for mesh in MESHES:
            cases[f"shardmap {no_drop} {_ids(mesh)}"] = _spec(
                moe, "train", mesh, batches=[moe["batch"]], lr=LR,
                keep=True, moe_impl="shardmap", twin=True,
                moe_no_drop=no_drop)
    cases["shardmap serve 2x2"] = _spec(
        moe, "serve", (2, 2), kv="f32", prompts=moe["prompts"],
        cache_len=CACHE, gen=GEN, moe_impl="shardmap", twin=True)
    cases["raises 1x4"] = {"kind": "raises", "mesh": (1, 4),
                           "cfgs": _bad_cfgs()}
    names = list(cases)
    got = run_ranks(mesh_sessions, 4, ([cases[n] for n in names],),
                    timeout_s=LIMIT,
                    workdir=str(tmp_path_factory.mktemp("ranks")))
    return {n: [got[r][i] for r in range(4)] for i, n in
            enumerate(names)}, ckpt


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
@pytest.mark.parametrize("name", list(ARCHS))
def test_train_step_on_mesh_matches_reference(refs, ranks, name, mesh):
    """The MoE: the dense impl's global capacity, with drops."""
    ref = refs[name]
    res = ranks[0][f"{name} train {_ids(mesh)}"]
    assert all(r["losses"] == res[0]["losses"] for r in res)
    r0 = res[0]
    assert r0["losses"][0] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
    assert r0["grad_norms"][0] == pytest.approx(ref["grad_norm"], rel=1e-4)
    assert grads_check(r0["grads"], ref["grads"]) <= 1.0
    step_check(r0["params"], ref["step"], ref["grads"], LR, band=10)
    if name == "moe":
        assert r0["moe"]["dropped"] > 0


@pytest.mark.parametrize("name", list(ARCHS))
def test_grad_accum_on_mesh_matches_one_process(ranks, name):
    twin = ranks[0][f"{name} ga2 2x2"][0]["twin"]
    assert twin["loss_rel_err"] <= LOSS_RTOL
    assert twin["grads_err_over_limit"] <= 1.0
    assert twin["params"]["worst"] <= 1.0


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
@pytest.mark.parametrize("name", list(ARCHS))
def test_decode_on_mesh_matches_reference(refs, ranks, name, mesh):
    """Prefill and greedy decode over the mesh: logits within 1e-4 of the
    reference's, tokens identical, every rank the same."""
    ref = refs[name]
    res = ranks[0][f"{name} serve {_ids(mesh)}"]
    for r in res:
        assert torch.equal(r["tokens"], res[0]["tokens"])
    r0 = res[0]
    np.testing.assert_allclose(r0["prefill"].numpy(), ref["prefill"],
                               atol=LOGIT_TOL, rtol=0)
    for got, w in zip(r0["steps"], ref["steps"]):
        np.testing.assert_allclose(got.numpy(), w, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(r0["tokens"].numpy(), ref["tokens"])


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
@pytest.mark.parametrize("name", ["rwkv6", "zamba2"])
def test_gathered_cache_is_the_references(refs, ranks, name, mesh):
    """Each rank holds its rows and its heads' states (and its extent of
    the shared block's K/V); gathered whole after the decode steps they
    are the reference's cache."""
    ref = refs[name]
    r0 = ranks[0][f"{name} serve {_ids(mesh)}"][0]
    got = r0["cache_whole"]
    assert set(got) == set(ref["cache"])
    for k, w in ref["cache"].items():
        np.testing.assert_allclose(got[k].float().numpy(), w, atol=1e-4,
                                   rtol=0, err_msg=k)
    shapes = r0["cache_shapes"]
    cfg = ref["cfg"]
    rows = B // mesh[0]
    if name == "rwkv6":
        heads = cfg.d_model // cfg.ssm_head_dim
        assert shapes["wkv"][1:3] == [rows, heads // mesh[1]]
        assert shapes["shift_tm"] == [cfg.n_layers, rows, cfg.d_model]
    else:
        d_inner = 2 * cfg.d_model
        assert shapes["ssm"][2] == d_inner // cfg.ssm_head_dim // mesh[1]
        assert shapes["conv"][-1] == (d_inner // mesh[1] +
                                      2 * cfg.ssm_state)
        assert shapes["k"][3] == CACHE // mesh[1]


@pytest.mark.parametrize("no_drop", [False, True], ids=["drop", "nodrop"])
def test_shardmap_matches_reference(refs, shardmap_ref, ranks, no_drop):
    """The expert-parallel MoE on (2, 2): local capacity a data rank, the
    local aux averaged over data, against the reference's
    ``apply_moe_shardmap``; with drops it is not the global routing."""
    r0 = ranks[0][f"shardmap {no_drop} 2x2"][0]
    name = "nodrop" if no_drop else "drop"
    loss, norm = shardmap_ref["losses"][name]
    assert r0["losses"][0] == pytest.approx(loss, rel=LOSS_RTOL)
    assert r0["grad_norms"][0] == pytest.approx(norm, rel=1e-4)
    assert grads_check(r0["grads"], shardmap_ref[name]) <= 1.0
    if not no_drop:
        assert r0["moe"]["dropped"] > 0
        assert abs(r0["losses"][0] - refs["moe"]["loss"]) > 1e-4


@pytest.mark.parametrize("no_drop", [False, True], ids=["drop", "nodrop"])
@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
def test_shardmap_matches_its_one_process_model(ranks, mesh, no_drop):
    """Rank 0's twin: on (2, 2) each data rank's rows routed alone (its
    local capacity, the aux averaged), on (1, 4) the one-process model."""
    twin = ranks[0][f"shardmap {no_drop} {_ids(mesh)}"][0]["twin"]
    assert twin["loss_rel_err"] <= LOSS_RTOL
    assert twin["grads_err_over_limit"] <= 1.0


def test_shardmap_routes_as_dense_on_one_data_rank(ranks):
    """On (1, 4) the shardmap impl's routing is the dense impl's, pair
    for pair (the same kept (token, slot, expert) sums on every rank)."""
    dense = ranks[0]["moe train 1x4"]
    smap = ranks[0]["shardmap False 1x4"]
    assert [r["moe"] for r in dense] == [r["moe"] for r in smap]


def test_shardmap_serves_as_its_one_process_model(ranks):
    twin = ranks[0]["shardmap serve 2x2"][0]["twin"]
    assert twin["tokens_equal"] and twin["prefill_err"] <= LOGIT_TOL


@pytest.mark.parametrize("i,what", [(0, "heads (3)"), (1, "SSM heads (6)"),
                                    (2, "attention heads (6/6)")])
def test_heads_that_do_not_split_raise(ranks, i, what):
    for r in ranks[0]["raises 1x4"]:
        assert what in r["raised"][i]


@pytest.fixture(scope="module")
def restored(refs, ranks, tmp_path_factory):
    _, ckpt = ranks
    cases = [_spec(r, "restore", mesh, dir=os.path.join(ckpt, name))
             for name, r in refs.items() for mesh in ((1, 2), (2, 1))]
    return run_ranks(mesh_sessions, 2, (cases,), timeout_s=LIMIT,
                     workdir=str(tmp_path_factory.mktemp("two")))


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)], ids=_ids)
@pytest.mark.parametrize("name", list(ARCHS))
def test_restore_onto_degraded_mesh(restored, name, mesh):
    i = 2 * list(ARCHS).index(name) + [(1, 2), (2, 1)].index(mesh)
    for r in restored:
        assert r[i]["local_equal"] and r[i]["whole_equal"]


def test_moe_impl_reaches_the_model():
    """``get_model(..., moe_impl=)`` is kept; another value raises; in one
    process the shardmap impl is the dense one."""
    cfg = get_arch("phi3.5-moe-42b-a6.6b").reduced()
    assert get_model(cfg, moe_impl="shardmap").impl.moe_impl == "shardmap"
    with pytest.raises(ValueError, match="moe_impl"):
        get_model(cfg, moe_impl="gspmd")
    dense = get_model(cfg)
    smap = get_model(cfg, moe_impl="shardmap")
    params = dense.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    a, _ = dense.forward(params, {"tokens": toks})
    b, _ = smap.forward(params, {"tokens": toks})
    assert torch.equal(a, b)
