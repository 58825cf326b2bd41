"""The model code on a ``(pod, data, model)`` mesh of ranks: the batch and
the FSDP shards over ``(pod, data)``, tensor parallelism over ``model``,
the decode cache's rows over ``data`` and its sequence over ``(pod,
model)`` (``launch.mesh.MeshPlacement``'s ``fsdp`` and ``seq`` axes),
against the JAX package on the same numpy inputs and against the port in
one process.

Reduced granite-3-2b (2 layers, d 64, 4 heads of 16, vocab 128; 127 for
the table that does not split), reduced rwkv6-3b, zamba2-1.2b (4 layers)
and phi3.5-moe (capacity factor 0.25, so that tokens drop), the
reference's init carried to the ranks as numpy.  The ranks are gloo
ranks on the CPU spawned by ``launch.mesh.run_ranks`` (a ``FileStore``
in ``tmp_path``, one thread a rank, every join limited to ``LIMIT`` s):
one spawn of 4 ranks runs the (2, 1, 2) and (2, 2, 1) cases and saves a
(2, 2) checkpoint, restoring it onto both, one of 8 every (2, 2, 2) case of
``scripts/mesh_sessions.py``, then one of 4 and one of 2 restore the
(2, 2, 2) checkpoint onto (2, 2) and (1, 2).  The reference's
``apply_moe_shardmap`` runs once in a subprocess with eight forced host
devices on a (2, 2, 2) mesh.

Held (``tests/test_torch_mesh.py``'s and ``test_torch_mesh_families.
py``'s tolerances): the train step's loss within 1e-5 rel of the
reference's, the pre-clip grad_norm 1e-4 rel, gradients 1e-4 x max(1,
max|g|), params by ``mesh_sessions.step_check`` (band 1 for the dense
model, 10 for the families); grad-accum 2 (remat full) and int8
compression against one process; decode logits within 1e-4 of the
reference's unsharded ``decode_step`` on f32 and int8 caches, greedy
tokens identical over 8 steps (6 for the families), the families' cache
gathered whole within 1e-4 of the reference's; the shardmap MoE against
the reference's on the same mesh; a batch of 2 split over ``pod`` alone,
params whose d splits over ``("pod",)`` alone and over ``"data"``, and a
vocabulary that does not divide; the prefill's cache moved to the decode
layout (its bytes counted); checkpoints between (2, 2, 2) and (2, 2) /
(1, 2) bit for bit, read by the reference's ``CheckpointManager``; a
cache that does not split over ``(pod, model)`` raises."""
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

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.data.pipeline import synthetic_stream  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import clip_by_global_norm as jclip  # noqa: E402
from repro.optim import warmup_cosine as jwarmup_cosine  # noqa: E402
from repro.runtime.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from mesh_sessions import (LOGIT_TOL, LOSS_RTOL, grads_check,  # noqa: E402
                           mesh_sessions, step_check)

LIMIT = 240                # seconds, every join of spawned ranks
POD = (2, 2, 2)
SMALL = [(2, 1, 2), (2, 2, 1)]
LR = ("warmup_cosine", 3e-3, 2, 10)
FAMILY_LR = 1e-3
B, PROMPT, CACHE, GEN = 4, 16, 32, 8
FB, FPROMPT, FCACHE, FGEN = 4, 16, 24, 6
FAMILIES = {"rwkv6": "rwkv6_3b", "zamba2": "zamba2_1_2b",
            "moe": "phi3_5_moe_42b_a6_6b"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(shape):
    return "x".join(map(str, shape))


def _train_ref(jm, jp, batch):
    """The reference's jitted step on ``batch``: loss, pre-clip norm, the
    clipped gradients fed to AdamW, params."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init, upd = jadamw(lr=jwarmup_cosine(*LR[1:]))
    p1, _, m = jax.jit(jmake_train_step(jm, upd))(jp, init(jp), jb)
    g = jax.jit(lambda p: jclip(jax.grad(
        lambda q: jm.loss(q, jb)[0])(p), 1.0)[0])(jp)
    return {"batch": batch, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "grads": jax.device_get(g),
            "step": jax.device_get(p1)}


def _dense_reference(vocab=None, int8=True, small_batch=False):
    """The JAX package's run on reduced granite-3-2b (vocabulary
    ``vocab``): one train step on 8 x 32 (and on 2 x 32 with
    ``small_batch``), a prefill of ``PROMPT`` tokens into a cache padded
    to ``CACHE`` positions, ``GEN`` greedy decode steps on the f32 cache
    and (``int8``) on its int8 quantization."""
    jcfg = jget_arch("granite_3_2b").reduced()
    if vocab:
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab)
    jm = jget_model(jcfg, compute_dtype=jnp.float32, remat="none")
    jp = jm.init(jax.random.PRNGKey(0))
    batch = synthetic_stream(0, 0, 0, batch=8, seq_len=32,
                             vocab=jcfg.vocab_size, kind="learnable")
    out = {"cfg": jcfg, "params": jax.device_get(jp),
           "train": _train_ref(jm, jp, batch)}
    if small_batch:
        out["train2"] = _train_ref(jm, jp, {k: v[:2]
                                            for k, v in batch.items()})
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, PROMPT), dtype=np.int32)
    logits, cache = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t}, cache_dtype=jnp.float32))(jp, jnp.asarray(prompts))
    pad = [(0, 0)] * 3 + [(0, CACHE - PROMPT), (0, 0)]
    f32 = {"index": cache["index"],
           **{n: jnp.pad(cache[n], pad) for n in ("k", "v")}}
    q8 = {"index": cache["index"]}
    for n in ("k", "v"):
        q8[n], q8[f"{n}_scale"] = JL.quantize_kv(f32[n])
    first = np.asarray(logits.argmax(-1))
    out.update(prompts=prompts, prefill=np.asarray(logits), first=first,
               cache_q8={k: (int(v) if k == "index" else np.asarray(v))
                         for k, v in q8.items()})
    runs = [("f32", f32, jax.jit(jm.decode_step))]
    if int8:
        jm8 = jget_model(jcfg, compute_dtype=jnp.float32, kv_quant="int8")
        runs.append(("int8", q8, jax.jit(jm8.decode_step)))
    for name, c, fn in runs:
        toks, steps = [first], []
        for _ in range(GEN):
            lg, c = fn(jp, c, jnp.asarray(toks[-1]))
            steps.append(np.asarray(lg))
            toks.append(np.asarray(lg.argmax(-1)))
        out[name] = {"steps": steps, "tokens": np.stack(toks, 1)}
    return out


def _family_cfg(name):
    cfg = jget_arch(FAMILIES[name]).reduced()
    if name == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=0.25)
    if name == "zamba2":                   # two applications of the block
        cfg = dataclasses.replace(cfg, n_layers=4)
    return cfg


def _family_reference(name):
    """The JAX package's one-process run (its GSPMD result over a mesh):
    one train step, a prefill of ``FPROMPT`` tokens, ``FGEN`` greedy
    decode steps (a KV cache padded to ``FCACHE`` positions), the cache
    after them."""
    jcfg = _family_cfg(name)
    jm = jget_model(jcfg, compute_dtype=jnp.float32, remat="none")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    batch = synthetic_stream(0, 0, 0, batch=8, seq_len=16,
                             vocab=jcfg.vocab_size, kind="learnable")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init, upd = jadamw(lr=FAMILY_LR)
    loss, g = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb)[0]))(jp)

    @jax.jit
    def update(g, p):
        g, norm = jclip(g, 1.0)
        return g, norm, upd(g, init(p), p)[0]
    g, norm, p1 = update(g, jp)
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (FB, FPROMPT), dtype=np.int32)
    logits, cache = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t}, cache_dtype=jnp.float32))(jp, jnp.asarray(prompts))
    if "k" in cache:
        pad = [(0, 0)] * 3 + [(0, FCACHE - FPROMPT), (0, 0)]
        cache = {**cache, **{n: jnp.pad(cache[n], pad) for n in ("k", "v")}}
    step = jax.jit(jm.decode_step)
    toks, steps = [np.asarray(logits.argmax(-1))], []
    for _ in range(FGEN):
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
def ref():
    return _dense_reference(small_batch=True)


@pytest.fixture(scope="module")
def ref127():
    return _dense_reference(vocab=127, int8=False)


@pytest.fixture(scope="module")
def refs():
    return {name: _family_reference(name) for name in FAMILIES}


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
axes = ("pod", "data", "model")
mesh = jax.make_mesh((2, 2, 2), axes, **auto_axis_kwargs(axes))
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
    """The reference's shardmap MoE jitted on an 8-device (2, 2, 2) mesh:
    loss, pre-clip norm and clipped gradients, with and without
    ``no_drop``."""
    import json

    d = tmp_path_factory.mktemp("smap")
    r = refs["moe"]
    np.savez(d / "in.npz", **{"params/" + k: v for k, v in
                              _flat(r["params"]).items()},
             tokens=r["batch"]["tokens"], labels=r["batch"]["labels"])
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
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


def _train(r, mesh, which="train", **kw):
    return _spec(r, "train", mesh, batches=[r[which]["batch"]], lr=LR, **kw)


def _serve(r, mesh, kv, **kw):
    if kv == "int8":
        kw.update(cache=r["cache_q8"], first=r["first"])
    return _spec(r, "serve", mesh, kv=kv, prompts=r["prompts"],
                 cache_len=CACHE, gen=GEN, **kw)


def _d66(mesh, **kw):
    """Reduced granite-3-2b at d 66 (heads of 16 kept): d divides 2 but
    not 4, so on (2, 2, 2) every FSDP dim splits over ``("pod",)`` alone
    and on (2, 2) over ``"data"``; a train step against one process."""
    cfg = dataclasses.replace(get_arch("granite-3-2b").reduced(), d_model=66)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 128, (8, 16)),
             "labels": rng.integers(0, 128, (8, 16))}
    return {"kind": "train", "cfg": dataclasses.asdict(cfg), "seed": 0,
            "mesh": mesh, "batches": [batch], "twin": True, **kw}


def _collect(got, names):
    n = len(got)
    return {name: [got[r][i] for r in range(n)] for i, name in
            enumerate(names)}


@pytest.fixture(scope="module")
def small(ref, refs, tmp_path_factory):
    """The (2, 1, 2) and (2, 2, 1) cases in one spawn of 4 ranks, and a
    (2, 2) checkpoint, restored onto (2, 1, 2) and (2, 2, 1) in the same
    spawn and onto (2, 2, 2) in the 8-rank one."""
    ckpt = str(tmp_path_factory.mktemp("ckpt22"))
    cases = {}
    for mesh in SMALL:
        m = _ids(mesh)
        cases[f"train {m}"] = _train(ref, mesh, keep=True)
        cases[f"int8 {m}"] = _train(ref, mesh, compression="int8", ga=2,
                                    remat="full", twin=True)
        for kv in ("f32", "int8"):
            cases[f"serve {kv} {m}"] = _serve(ref, mesh, kv)
        for name, r in refs.items():
            cases[f"{name} serve {m}"] = _spec(
                r, "serve", mesh, kv="f32", prompts=r["prompts"],
                cache_len=FCACHE, gen=FGEN, keep_cache=True)
    cases["d66 2x2"] = _d66((2, 2))
    cases["save 2x2"] = _spec(ref, "save", (2, 2), dir=ckpt, step=2)
    for mesh in SMALL:
        cases[f"restore 2x2 -> {_ids(mesh)}"] = _spec(ref, "restore", mesh,
                                                       dir=ckpt)
    names = list(cases)
    got = run_ranks(mesh_sessions, 4, ([cases[n] for n in names],),
                    timeout_s=LIMIT,
                    workdir=str(tmp_path_factory.mktemp("four")))
    return _collect(got, names), ckpt


@pytest.fixture(scope="module")
def ranks(ref, ref127, refs, shardmap_ref, small, tmp_path_factory):
    """Every (2, 2, 2) case in one spawn of 8 ranks, and its checkpoint."""
    del shardmap_ref                       # its subprocess first
    ckpt = str(tmp_path_factory.mktemp("ckpt222"))
    cases = {
        "train": _train(ref, POD, keep=True),
        "train b2": _train(ref, POD, "train2", keep=True),
        "ga2": _train(ref, POD, ga=2, remat="full", twin=True),
        "int8": _train(ref, POD, compression="int8", twin=True),
        "serve f32": _serve(ref, POD, "f32"),
        "serve int8": _serve(ref, POD, "int8"),
        "serve b2": _spec(ref, "serve", POD, kv="f32",
                          prompts=ref["prompts"][:2], cache_len=CACHE,
                          gen=4, twin=True),
        "train127": _train(ref127, POD, keep=True),
        "serve127": _serve(ref127, POD, "f32"),
        "d66": _d66(POD),
        "seq_raises": _spec(ref, "serve_raises", POD,
                            prompts=ref["prompts"], cache_len=CACHE - 2),
        "roundtrip": _spec(ref, "roundtrip", POD),
        "save": _spec(ref, "save", POD, dir=ckpt, step=3, blocking=False),
        "restore 2x2 -> 2x2x2": _spec(ref, "restore", POD, dir=small[1]),
    }
    for name, r in refs.items():
        cases[f"{name} train"] = _spec(r, "train", POD, batches=[r["batch"]],
                                       lr=FAMILY_LR, keep=True)
        cases[f"{name} serve"] = _spec(
            r, "serve", POD, kv="f32", prompts=r["prompts"],
            cache_len=FCACHE, gen=FGEN, keep_cache=True)
        cases[f"{name} ga2"] = _spec(r, "train", POD, batches=[r["batch"]],
                                     lr=FAMILY_LR, ga=2, remat="full",
                                     twin=True, step_band=10)
    moe = refs["moe"]
    cases["moe b2"] = _spec(moe, "train", POD, lr=FAMILY_LR, twin=True,
                            batches=[{k: v[:2] for k, v in
                                      moe["batch"].items()}])
    for no_drop in (False, True):
        cases[f"shardmap {no_drop}"] = _spec(
            moe, "train", POD, batches=[moe["batch"]], lr=FAMILY_LR,
            keep=True, moe_impl="shardmap", twin=True, moe_no_drop=no_drop)
    cases["shardmap serve"] = _spec(
        moe, "serve", POD, kv="f32", prompts=moe["prompts"],
        cache_len=FCACHE, gen=FGEN, moe_impl="shardmap", twin=True)
    names = list(cases)
    got = run_ranks(mesh_sessions, 8, ([cases[n] for n in names],),
                    timeout_s=LIMIT,
                    workdir=str(tmp_path_factory.mktemp("eight")))
    return _collect(got, names), ckpt


def _lr1():
    return float(jwarmup_cosine(*LR[1:])(jnp.int32(1)))


def _train_matches(r0, want, lr, band=1.0):
    assert r0["losses"][0] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    assert r0["grad_norms"][0] == pytest.approx(want["grad_norm"], rel=1e-4)
    assert grads_check(r0["grads"], want["grads"]) <= 1.0
    step_check(r0["params"], want["step"], want["grads"], lr, band=band)


def _mesh_run(ranks, small, mesh, name):
    return (ranks[0] if mesh == POD else small[0])[
        name if mesh == POD else f"{name} {_ids(mesh)}"]


@pytest.mark.parametrize("mesh", [POD] + SMALL, ids=_ids)
def test_train_step_on_pod_mesh_matches_reference(ref, ranks, small, mesh):
    """FSDP over (pod, data), tensor parallelism over model: one step of
    8 x 32 against the reference's jitted step."""
    res = _mesh_run(ranks, small, mesh, "train")
    assert all(r["losses"] == res[0]["losses"] for r in res)
    r0 = res[0]
    _train_matches(r0, ref["train"], _lr1())
    assert r0["collectives"]["reduce_scatter"] > 0


def test_batch_that_splits_over_pod_alone(ref, ranks):
    """A batch of 2 on (2, 2, 2): its rows split over ``("pod",)`` alone
    (``axes_if_div``'s prefix), each pod's two data ranks holding the same
    row; the loss is still the mean over the 2 rows, the gradients the
    reference's."""
    sizes = {"pod": 2, "data": 2, "model": 2}
    assert shd.batch_spec(sizes, {"tokens": ((2, 32), None)}) == {
        "tokens": ("pod", None)}
    r0 = ranks[0]["train b2"][0]
    _train_matches(r0, ref["train2"], _lr1())


@pytest.mark.parametrize("mesh", [POD, (2, 2)], ids=_ids)
def test_fsdp_over_the_spec_axes(ranks, small, mesh):
    """d 66 splits over ``("pod",)`` alone on (2, 2, 2) (replicated over
    data: its gradient reduce-scattered over pod, all-reduced over data)
    and over ``"data"`` on (2, 2); a step against one process."""
    sizes = dict(zip(("pod", "data", "model")[-len(mesh):], mesh))
    spec = shd.param_spec(sizes, ("layers", "attn", "wq"), (2, 66, 64))
    assert spec[1] == ("pod" if mesh == POD else "data")
    r0 = (ranks[0]["d66"] if mesh == POD else small[0]["d66 2x2"])[0]
    twin = r0["twin"]
    assert twin["loss_rel_err"] <= LOSS_RTOL
    assert twin["grads_err_over_limit"] <= 1.0
    assert twin["params"]["worst"] <= 1.0


@pytest.mark.parametrize("case", ["ga2 2x2x2", "int8 2x2x2", "int8 2x1x2",
                                  "int8 2x2x1"])
def test_grad_accum_and_int8_on_pod_mesh_match_one_process(ranks, small,
                                                           case):
    name, mesh = case.split()
    res = ranks[0][name] if mesh == "2x2x2" else small[0][case]
    assert all(r["losses"] == res[0]["losses"] for r in res)
    twin = res[0]["twin"]
    assert twin["loss_rel_err"] <= LOSS_RTOL
    assert twin["params"]["worst"] <= 1.0
    if name == "int8":
        assert twin["g32_err_over_limit"] <= 1.0


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("mesh", [POD] + SMALL, ids=_ids)
def test_decode_on_pod_mesh_matches_reference(ref, ranks, small, mesh, kv):
    """The cache's rows over data, its sequence over (pod, model): every
    step's logits within 1e-4 of the reference's unsharded
    ``decode_step``, tokens identical.  f32: the port's prefill on the
    mesh, its cache moved from rows over (pod, data) to the decode layout
    (the ``redistribute`` bytes); int8: the reference's quantized cache,
    sharded by ``cache_spec_shardings``."""
    res = _mesh_run(ranks, small, mesh, f"serve {kv}")
    want = ref[kv]
    for r in res:
        assert torch.equal(r["tokens"], res[0]["tokens"])
    r0 = res[0]
    pod, data, model = mesh
    cfg = ref["cfg"]
    assert r0["cache_shape"] == [cfg.n_layers, B // data, cfg.n_kv_heads,
                                 CACHE // (pod * model), cfg.hd]
    if kv == "f32":
        np.testing.assert_allclose(r0["prefill"].numpy(), ref["prefill"],
                                   atol=LOGIT_TOL, rtol=0)
        moved = r0["collectives_session"]["redistribute_bytes"]
        # each rank sends its prefill rows' K/V at the pod extents of its
        # model index: 2 x L x B / (pod x data) x Hkv x CACHE / model x D
        assert moved == 2 * cfg.n_layers * B // (pod * data) * \
            cfg.n_kv_heads * CACHE // model * cfg.hd * 4
    for got, w in zip(r0["steps"], want["steps"]):
        np.testing.assert_allclose(got.numpy(), w, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(r0["tokens"].numpy(), want["tokens"])
    # the D-Cache merge crossed (pod, model) every token
    assert r0["collectives"]["all_reduce"] >= GEN * cfg.n_layers


def test_decode_of_a_batch_that_splits_over_pod_alone(ranks):
    """Prefill of 2 rows on (2, 2, 2) splits them over pod; decode over
    data: the cache moves, the tokens are one process's."""
    twin = ranks[0]["serve b2"][0]["twin"]
    assert twin["tokens_equal"] and twin["prefill_err"] <= LOGIT_TOL
    assert twin["first_step_err"] <= twin["limit"]


@pytest.mark.parametrize("what", ["train", "decode"])
def test_vocab_not_dividing_on_pod_mesh(ref127, ranks, what):
    """A vocabulary of 127: the tied table split over d on model, FSDP
    nowhere (its d is model's), against the reference."""
    sizes = {"pod": 2, "data": 2, "model": 2}
    assert shd.param_spec(sizes, ("embed", "table"), (127, 64)) == (
        None, "model")
    if what == "train":
        _train_matches(ranks[0]["train127"][0], ref127["train"], _lr1())
    else:
        r0 = ranks[0]["serve127"][0]
        np.testing.assert_allclose(r0["prefill"].numpy(), ref127["prefill"],
                                   atol=LOGIT_TOL, rtol=0)
        for got, w in zip(r0["steps"], ref127["f32"]["steps"]):
            np.testing.assert_allclose(got.numpy(), w, atol=LOGIT_TOL,
                                       rtol=0)
        np.testing.assert_array_equal(r0["tokens"].numpy(),
                                      ref127["f32"]["tokens"])


def test_cache_that_does_not_split_raises(ranks):
    for r in ranks[0]["seq_raises"]:
        assert "does not split over pod,model = 4" in r["raised"]


def test_shard_gather_round_trip_on_pod_ranks(ranks):
    assert all(r["bit_equal"] for r in ranks[0]["roundtrip"])


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_train_step_on_pod_mesh_matches_reference(refs, ranks, name):
    """RWKV6, Zamba2 and the MoE (the dense impl's global capacity, with
    drops) on (2, 2, 2) against the reference's one-process step."""
    ref = refs[name]
    res = ranks[0][f"{name} train"]
    assert all(r["losses"] == res[0]["losses"] for r in res)
    r0 = res[0]
    assert r0["losses"][0] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
    assert r0["grad_norms"][0] == pytest.approx(ref["grad_norm"], rel=1e-4)
    assert grads_check(r0["grads"], ref["grads"]) <= 1.0
    step_check(r0["params"], ref["step"], ref["grads"], FAMILY_LR, band=10)
    if name == "moe":
        assert r0["moe"]["dropped"] > 0


@pytest.mark.parametrize("name", list(FAMILIES) + ["moe b2"])
def test_family_grad_accum_on_pod_mesh_matches_one_process(ranks, name):
    """grad-accum 2 against one process; ``moe b2``: the MoE on a batch of
    2 split over pod alone (the global routing over the rows' pod ranks,
    the aux's means over every (pod, data) rank)."""
    twin = ranks[0][name if name == "moe b2" else f"{name} ga2"][0]["twin"]
    assert twin["loss_rel_err"] <= LOSS_RTOL
    assert twin["grads_err_over_limit"] <= 1.0
    assert twin["params"]["worst"] <= 1.0


@pytest.mark.parametrize("mesh", [POD] + SMALL, ids=_ids)
@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_decode_on_pod_mesh_matches_reference(refs, ranks, small,
                                                     name, mesh):
    """Prefill and greedy decode: logits within 1e-4 of the reference's,
    tokens identical, every rank the same; the cache gathered whole is
    the reference's."""
    ref = refs[name]
    res = _mesh_run(ranks, small, mesh, f"{name} serve")
    for r in res:
        assert torch.equal(r["tokens"], res[0]["tokens"])
    r0 = res[0]
    np.testing.assert_allclose(r0["prefill"].numpy(), ref["prefill"],
                               atol=LOGIT_TOL, rtol=0)
    for got, w in zip(r0["steps"], ref["steps"]):
        np.testing.assert_allclose(got.numpy(), w, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(r0["tokens"].numpy(), ref["tokens"])
    got = r0["cache_whole"]
    assert set(got) == set(ref["cache"])
    for k, w in ref["cache"].items():
        np.testing.assert_allclose(got[k].float().numpy(), w, atol=1e-4,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["rwkv6", "zamba2"])
def test_family_cache_layout_on_pod_mesh(refs, ranks, name):
    """RWKV6's states: rows over (pod, data), as ``cache_spec_shardings``
    places them, heads over model.  Zamba2's: every tensor's rows over
    data (the K/V's, which the states follow; ROADMAP §C), the K/V's
    sequence over (pod, model), the states' heads over model."""
    cfg = refs[name]["cfg"]
    shapes = ranks[0][f"{name} serve"][0]["cache_shapes"]
    if name == "rwkv6":
        heads = cfg.d_model // cfg.ssm_head_dim
        assert shapes["wkv"][1:3] == [FB // 4, heads // 2]
        assert shapes["shift_tm"] == [cfg.n_layers, FB // 4, cfg.d_model]
    else:
        d_inner = 2 * cfg.d_model
        assert shapes["k"][1] == shapes["conv"][1] == shapes["ssm"][1] == \
            FB // 2
        assert shapes["k"][3] == FCACHE // 4
        assert shapes["ssm"][2] == d_inner // cfg.ssm_head_dim // 2


@pytest.mark.parametrize("no_drop", [False, True], ids=["drop", "nodrop"])
def test_shardmap_matches_reference_on_pod_mesh(refs, shardmap_ref, ranks,
                                                no_drop):
    """Each (pod, data) rank routes its own tokens with the local capacity,
    the aux averaged over (pod, data): against the reference's
    ``apply_moe_shardmap`` jitted on the same (2, 2, 2) mesh, and against
    its one-process model (``mesh_sessions.DataBlocks``, 4 blocks)."""
    r0 = ranks[0][f"shardmap {no_drop}"][0]
    name = "nodrop" if no_drop else "drop"
    loss, norm = shardmap_ref["losses"][name]
    assert r0["losses"][0] == pytest.approx(loss, rel=LOSS_RTOL)
    assert r0["grad_norms"][0] == pytest.approx(norm, rel=1e-4)
    assert grads_check(r0["grads"], shardmap_ref[name]) <= 1.0
    twin = r0["twin"]
    assert twin["loss_rel_err"] <= LOSS_RTOL
    assert twin["grads_err_over_limit"] <= 1.0
    if not no_drop:
        assert r0["moe"]["dropped"] > 0
        assert abs(r0["losses"][0] - refs["moe"]["loss"]) > 1e-4


def test_shardmap_serves_as_its_one_process_model_on_pod_mesh(ranks):
    twin = ranks[0]["shardmap serve"][0]["twin"]
    assert twin["tokens_equal"] and twin["prefill_err"] <= LOGIT_TOL


@pytest.fixture(scope="module")
def restored(ref, ranks, tmp_path_factory):
    """The (2, 2, 2) checkpoint restored onto (2, 2) (4 ranks) and (1, 2)
    (2 ranks)."""
    _, ckpt = ranks
    out = {}
    for n, mesh in ((4, (2, 2)), (2, (1, 2))):
        got = run_ranks(mesh_sessions, n,
                        ([_spec(ref, "restore", mesh, dir=ckpt)],),
                        timeout_s=LIMIT,
                        workdir=str(tmp_path_factory.mktemp(f"r{n}")))
        out[mesh] = [g[0] for g in got]
    return out


@pytest.mark.parametrize("mesh", [(2, 2), (1, 2)], ids=_ids)
def test_pod_checkpoint_restores_onto_smaller_mesh(restored, mesh):
    """Saved (async) from shards on (2, 2, 2), restored onto ``mesh``: each
    rank's slices are ``shard_tree``'s and gathered whole they are the
    weights, bit for bit."""
    for r in restored[mesh]:
        assert r["local_equal"] and r["whole_equal"]


@pytest.mark.parametrize("mesh", SMALL, ids=_ids)
def test_checkpoint_from_2x2_restores_onto_small_pod_mesh(small, mesh):
    """Saved from shards on (2, 2), restored onto ``mesh`` by the same 4
    ranks: each rank's slices are ``shard_tree``'s and gathered whole they
    are the weights, bit for bit."""
    for r in small[0][f"restore 2x2 -> {_ids(mesh)}"]:
        assert r["local_equal"] and r["whole_equal"]


def test_checkpoint_from_2x2_restores_onto_pod_mesh(ranks):
    for r in ranks[0]["restore 2x2 -> 2x2x2"]:
        assert r["local_equal"] and r["whole_equal"]
    shapes = ranks[0]["restore 2x2 -> 2x2x2"][0]["local_shapes"]
    assert shapes["/layers/attn/wq"] == [2, 64 // 4, 64 // 2]


def test_reference_reads_the_pod_checkpoint(ref, ranks):
    got = JCheckpointManager(ranks[1]).restore(ref["params"], step=3)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)
