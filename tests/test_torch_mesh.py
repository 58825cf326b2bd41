"""The dense transformer over a ``(data, model)`` mesh of ranks: training
(``make_train_step(..., mesh=)``), serving with the KV cache
sequence-sharded over ``model`` (``make_serving_fns(model, mesh)``, the
D-Cache schedule), checkpoints restored onto another mesh, and the
placement (``shard_tree`` / ``gather_tree``), against the JAX package on
the same numpy inputs and against the port in one process.

Reduced granite-3-2b (2 layers, d 64, 4 heads of 16, vocab 128), the
reference's init carried to the ranks as numpy (``params_from_jax``, then
``shard_tree``).  The ranks are gloo ranks on the CPU spawned by
``launch.mesh.run_ranks`` (a ``FileStore`` in ``tmp_path``, one thread a
rank, every join limited to ``LIMIT`` s): one spawn of 4 ranks runs every
(2, 2) and (1, 4) case of ``scripts/mesh_sessions.py``, one of 2 ranks
the restores onto (1, 2) and (2, 1), one of 1 rank the bit-equality with
``mesh=None``.  Held: loss 1e-5 rel, the pre-clip grad_norm 1e-4 rel,
gradients 1e-4 x max(1, max|g|),
params after a step by ``mesh_sessions.step_check`` (the reference's
atol 2e-5 / rtol 2e-4; elements with a gradient below AdamW's eps take
the bound GRAD_TOL implies); decode logits within 1e-4 of the
reference's unsharded ``decode_step`` (f32 and int8 caches) and greedy
tokens identical over 8 steps; a vocabulary of 127 (no split over 2 or
4: the table split over d); grad-accum 2 (remat full) and int8
compression against one process; restores bit for bit, the checkpoint
read by the reference's ``CheckpointManager``; RWKV6, Zamba2 and the MoE
transformer serve over a mesh as in one process (their parity with the
reference: ``tests/test_torch_mesh_families.py``)."""
import dataclasses
import os
import sys

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
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the session harness; spawned ranks import it by name from this path
sys.path.insert(0, os.path.join(REPO, "scripts"))
from mesh_sessions import (GRAD_TOL, LOGIT_TOL, LOSS_RTOL,  # noqa: E402
                           grads_check, mesh_sessions, step_check)

LIMIT = 240                # seconds, every join of spawned ranks
# the other products of the dense layers over a mesh, reduced, against
# one process: QKV biases and an untied lm_head (qwen2-72b), the plain
# GeLU MLP with its biases (hubert-xlarge's, in reduced granite-3-2b: the
# hubert model trains no embedding table)
_OTHER_ARCHS = {
    "qwen2-72b": dataclasses.asdict(get_arch("qwen2-72b").reduced()),
    "gelu-mlp": dataclasses.asdict(dataclasses.replace(
        get_arch("granite-3-2b").reduced(), act="gelu"))}
MESHES = [(2, 2), (1, 4)]
FAMILIES = ["rwkv6-3b", "zamba2-1.2b", "phi3.5-moe-42b-a6.6b"]
LR = ("warmup_cosine", 3e-3, 2, 10)
B, PROMPT, CACHE, GEN = 4, 16, 32, 8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(shape):
    return "x".join(map(str, shape))


def _reference(vocab=None):
    """The JAX package's run on reduced granite-3-2b (vocabulary
    ``vocab``): one train step (loss, the clipped gradients it fed AdamW,
    params), a prefill of ``PROMPT`` tokens into a cache padded to
    ``CACHE`` positions, then ``GEN`` greedy decode steps on the f32 cache
    and on its int8 quantization; and the numpy inputs."""
    jcfg = jget_arch("granite_3_2b").reduced()
    if vocab:
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab)
    jm = jget_model(jcfg, compute_dtype=jnp.float32, remat="none")
    jp = jm.init(jax.random.PRNGKey(0))
    batch = synthetic_stream(0, 0, 0, batch=8, seq_len=32,
                             vocab=jcfg.vocab_size, kind="learnable")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init, upd = jadamw(lr=jwarmup_cosine(*LR[1:]))
    p1, _, m = jax.jit(jmake_train_step(jm, upd))(jp, init(jp), jb)
    g = jax.grad(lambda p: jm.loss(p, jb)[0])(jp)
    g, _ = jclip(g, 1.0)
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, PROMPT), dtype=np.int32)
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)},
                               cache_dtype=jnp.float32)
    pad = [(0, 0)] * 3 + [(0, CACHE - PROMPT), (0, 0)]
    f32 = {"index": cache["index"],
           **{n: jnp.pad(cache[n], pad) for n in ("k", "v")}}
    q8 = {"index": cache["index"]}
    for n in ("k", "v"):
        q8[n], q8[f"{n}_scale"] = JL.quantize_kv(f32[n])
    first = np.asarray(logits.argmax(-1))
    out = {"cfg": jcfg, "params": jax.device_get(jp), "batch": batch,
           "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "grads": jax.device_get(g),
           "step": jax.device_get(p1), "prompts": prompts,
           "prefill": np.asarray(logits), "first": first,
           "cache_q8": {k: (int(v) if k == "index" else np.asarray(v))
                        for k, v in q8.items()}}
    step = jax.jit(jm.decode_step)
    jm8 = jget_model(jcfg, compute_dtype=jnp.float32, kv_quant="int8")
    step8 = jax.jit(jm8.decode_step)
    for name, c, fn in (("f32", f32, step), ("int8", q8, step8)):
        toks, steps = [first], []
        for _ in range(GEN):
            lg, c = fn(jp, c, jnp.asarray(toks[-1]))
            steps.append(np.asarray(lg))
            toks.append(np.asarray(lg.argmax(-1)))
        out[name] = {"steps": steps, "tokens": np.stack(toks, 1)}
    return out


@pytest.fixture(scope="module")
def ref():
    return _reference()


@pytest.fixture(scope="module")
def ref127():
    return _reference(vocab=127)


def _spec(r, kind, mesh, **kw):
    return {"kind": kind, "cfg": dataclasses.asdict(r["cfg"]),
            "params": r["params"], "mesh": mesh, **kw}


def _train(r, mesh, **kw):
    return _spec(r, "train", mesh, batches=[r["batch"]], lr=LR, **kw)


def _serve(r, mesh, kv, **kw):
    if kv == "int8":
        kw.update(cache=r["cache_q8"], first=r["first"])
    return _spec(r, "serve", mesh, kv=kv, prompts=r["prompts"],
                 cache_len=CACHE, gen=GEN, **kw)


@pytest.fixture(scope="module")
def ranks(ref, ref127, tmp_path_factory):
    """Every (2, 2) and (1, 4) case in one spawn of 4 ranks: {name:
    [each rank's result]}, and the checkpoint directory."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    cases = {}
    for mesh in MESHES:
        m = _ids(mesh)
        cases[f"train {m}"] = _train(ref, mesh, keep=True)
        cases[f"ga2 {m}"] = _train(ref, mesh, ga=2, remat="full", twin=True)
        cases[f"int8 {m}"] = _train(ref, mesh, compression="int8",
                                    twin=True)
        for kv in ("f32", "int8"):
            cases[f"serve {kv} {m}"] = _serve(ref, mesh, kv)
    cases["train127 2x2"] = _train(ref127, (2, 2), keep=True)
    cases["serve127 2x2"] = _serve(ref127, (2, 2), "f32")
    for arch, cfg in _OTHER_ARCHS.items():
        rng = np.random.default_rng(3)
        batch = {"tokens": rng.integers(0, 128, (8, 16)),
                 "labels": rng.integers(0, 128, (8, 16))}
        cases[f"{arch} serve 2x2"] = {
            "kind": "serve", "cfg": cfg, "seed": 0, "mesh": (2, 2),
            "kv": "f32", "prompts": batch["tokens"][:4], "cache_len": 20,
            "gen": 4, "twin": True}
        cases[f"{arch} train 2x2"] = {
            "kind": "train", "cfg": cfg, "seed": 0, "mesh": (2, 2),
            "batches": [batch], "twin": True}
    for arch in FAMILIES:
        cfg = dataclasses.asdict(get_arch(arch).reduced())
        prompts = np.random.default_rng(4).integers(0, 128, (4, 16))
        cases[f"{arch} serve 2x2"] = {
            "kind": "serve", "cfg": cfg, "seed": 0, "mesh": (2, 2),
            "kv": "f32", "prompts": prompts, "cache_len": 20, "gen": 4,
            "twin": True}
    cases["roundtrip 2x2"] = _spec(ref, "roundtrip", (2, 2))
    cases["save 2x2"] = _spec(ref, "save", (2, 2), dir=ckpt, step=3,
                              blocking=False)
    cases["bad_mesh 1x2"] = _spec(ref, "bad_mesh", (1, 2))
    names = list(cases)
    got = run_ranks(mesh_sessions, 4, ([cases[n] for n in names],),
                    timeout_s=LIMIT,
                    workdir=str(tmp_path_factory.mktemp("ranks")))
    return {n: [got[r][i] for r in range(4)] for i, n in
            enumerate(names)}, ckpt


def _losses_agree(res):
    assert all(r["losses"] == res[0]["losses"] for r in res)


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
def test_train_step_on_mesh_matches_reference(ref, ranks, mesh):
    res = ranks[0][f"train {_ids(mesh)}"]
    _losses_agree(res)
    r0 = res[0]
    assert r0["losses"][0] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
    # the pre-clip norm counts each element of a replicated leaf once
    assert r0["grad_norms"][0] == pytest.approx(ref["grad_norm"], rel=1e-4)
    assert grads_check(r0["grads"], ref["grads"]) <= 1.0
    got = step_check(r0["params"], ref["step"], ref["grads"],
                     float(jwarmup_cosine(*LR[1:])(jnp.int32(1))))
    print(f"{mesh}: {got['exempt']} of {got['elements']} elements took "
          f"the GRAD_TOL bound")
    # the collectives of an FSDP x TP step ran
    assert r0["collectives"]["all_reduce"] > 0
    if mesh[0] > 1:
        assert r0["collectives"]["reduce_scatter"] > 0


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
@pytest.mark.parametrize("case", ["ga2", "int8"])
def test_grad_accum_and_int8_on_mesh_match_one_process(ranks, mesh, case):
    """grad-accum 2 (remat full) and int8 compression with error feedback
    against the same step in one process (rank 0's twin): loss, the
    gradients (int8: before compression; a compressed element may take
    the other side of a rounding boundary, one step of its row's
    scale), params by ``step_check`` (int8: each element also takes the
    gap that one step of the reference's row scale opens in AdamW's
    first step), the pre-clip grad_norm 1e-5 rel."""
    res = ranks[0][f"{case} {_ids(mesh)}"]
    _losses_agree(res)
    twin = res[0]["twin"]
    assert twin["loss_rel_err"] <= LOSS_RTOL
    assert twin["params"]["worst"] <= 1.0
    if case == "int8":
        assert twin["g32_err_over_limit"] <= 1.0
        print(f"{mesh}: {twin['int8_flips']} int8 elements a step apart")


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
def test_decode_on_mesh_matches_reference(ref, ranks, mesh, kv):
    """Greedy decode over the mesh, the cache sequence-sharded over
    ``model``: every step's logits within 1e-4 of the reference's
    unsharded ``decode_step``, the tokens identical; the cache on a rank
    is its rows and its extent, every head.  f32: the port's own prefill
    on the mesh; int8: the reference's quantized cache, sharded."""
    res = ranks[0][f"serve {kv} {_ids(mesh)}"]
    want = ref[kv]
    for r in res:
        assert torch.equal(r["tokens"], res[0]["tokens"])
    r0 = res[0]
    cfg = ref["cfg"]
    assert r0["cache_shape"] == [cfg.n_layers, B // mesh[0], cfg.n_kv_heads,
                                 CACHE // mesh[1], cfg.hd]
    if kv == "f32":
        np.testing.assert_allclose(r0["prefill"].numpy(), ref["prefill"],
                                   atol=LOGIT_TOL, rtol=0)
    for got, w in zip(r0["steps"], want["steps"]):
        np.testing.assert_allclose(got.numpy(), w, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(r0["tokens"].numpy(), want["tokens"])
    # the D-Cache merge crossed the model axis every token
    assert r0["collectives"]["all_reduce"] >= GEN * cfg.n_layers


@pytest.mark.parametrize("what", ["train", "decode"])
def test_vocab_not_dividing_splits_the_table_over_d(ref127, ranks, what):
    """A vocabulary of 127 divides neither 2 nor 4: the tied table is
    split over d (the lookup gathers d, the logits are partial sums over
    d reduced over ``model``), against the reference."""
    spec = shd.param_spec({"data": 2, "model": 2}, ("embed", "table"),
                          (127, 64))
    assert spec == (None, "model")
    if what == "train":
        r0 = ranks[0]["train127 2x2"][0]
        assert r0["losses"][0] == pytest.approx(ref127["loss"],
                                                rel=LOSS_RTOL)
        assert r0["grad_norms"][0] == pytest.approx(ref127["grad_norm"],
                                                    rel=1e-4)
        assert grads_check(r0["grads"], ref127["grads"]) <= 1.0
        step_check(r0["params"], ref127["step"], ref127["grads"],
                   float(jwarmup_cosine(*LR[1:])(jnp.int32(1))))
    else:
        r0 = ranks[0]["serve127 2x2"][0]
        np.testing.assert_allclose(r0["prefill"].numpy(), ref127["prefill"],
                                   atol=LOGIT_TOL, rtol=0)
        for got, w in zip(r0["steps"], ref127["f32"]["steps"]):
            np.testing.assert_allclose(got.numpy(), w, atol=LOGIT_TOL,
                                       rtol=0)
        np.testing.assert_array_equal(r0["tokens"].numpy(),
                                      ref127["f32"]["tokens"])


@pytest.fixture(scope="module")
def one_rank(ref, tmp_path_factory):
    cases = [_train(ref, (1, 1), twin=True, bit_equal=True, ga=2,
                    compression="int8"),
             _train(ref, (1, 1), twin=True, bit_equal=True),
             _serve(ref, (1, 1), "f32", twin=True, bit_equal=True),
             _serve(ref, (1, 1), "int8", twin=True, bit_equal=True)]
    return run_ranks(mesh_sessions, 1, (cases,), timeout_s=LIMIT,
                     workdir=str(tmp_path_factory.mktemp("one")))[0]


@pytest.mark.parametrize("i", range(4), ids=["train ga2 int8", "train",
                                             "serve f32", "serve int8"])
def test_one_rank_mesh_is_bit_equal_to_no_mesh(one_rank, i):
    assert one_rank[i]["twin"]["bit_equal"]


@pytest.fixture(scope="module")
def restored(ref, ranks, tmp_path_factory):
    _, ckpt = ranks
    cases = [_spec(ref, "restore", mesh, dir=ckpt) for mesh in ((1, 2),
                                                                 (2, 1))]
    return run_ranks(mesh_sessions, 2, (cases,), timeout_s=LIMIT,
                     workdir=str(tmp_path_factory.mktemp("two")))


@pytest.mark.parametrize("i,mesh", [(0, (1, 2)), (1, (2, 1))],
                         ids=["1x2", "2x1"])
def test_restore_onto_degraded_mesh(ref, restored, i, mesh):
    """Saved (async) from shards on (2, 2), restored onto 2 ranks: each
    rank's slices are ``shard_tree``'s under the new mesh and gathered
    whole they are the weights, bit for bit."""
    for r in restored:
        assert r[i]["local_equal"] and r[i]["whole_equal"]
    shapes = restored[0][i]["local_shapes"]
    assert shapes["/layers/attn/wq"][-1] == 64 // mesh[1]


def test_reference_reads_the_mesh_checkpoint(ref, ranks):
    """The rank-0 write of a sharded tree is the reference's format."""
    got = JCheckpointManager(ranks[1]).restore(ref["params"], step=3)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_shard_gather_round_trip_on_ranks(ranks):
    assert all(r["bit_equal"] for r in ranks[0]["roundtrip 2x2"])


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8), (8, 1), (3, 2),
                                   (2, 2, 2)], ids=_ids)
def test_shard_assemble_round_trip(shape):
    """``shard_tree`` at every coordinate, put back by ``assemble_leaf``:
    the tree bit for bit, on the meshes of ``test_torch_sharding.py``
    (tuple axes on the pod mesh)."""
    import itertools

    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    sizes = dict(zip(names, shape))
    for arch in ("granite-3-2b", "phi3.5-moe-42b-a6.6b", "rwkv6-3b"):
        model = get_model(get_arch(arch).reduced())
        params = model.init(torch.Generator().manual_seed(0))
        specs = shd.param_specs(sizes, params)
        coords = list(itertools.product(*map(range, shape)))
        shards = {c: shd.shard_tree(params, sizes, specs,
                                    coord=dict(zip(names, c)))
                  for c in coords}
        for path, spec in _walk(specs):
            whole = shd.assemble_leaf({c: _get(shards[c], path)
                                       for c in coords}, sizes, spec)
            assert torch.equal(whole, _get(params, path)), (arch, path)
    tuple_spec = shd.param_spec(sizes, ("layers", "attn", "wq"),
                                (2, 64, 64))
    if len(shape) == 3:
        assert tuple_spec[1] == ("pod", "data")


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_mesh_of_fewer_ranks_raises(ranks):
    for r in ranks[0]["bad_mesh 1x2"]:
        assert "over a group of 4" in r["raised"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_over_a_mesh_serve_as_one_process(ranks, arch):
    """RWKV6, Zamba2 and the MoE transformer placed on (2, 2) by
    ``make_serving_fns(model, mesh)``: prefill and 4 greedy tokens
    against the same work in one process (rank 0's twin)."""
    res = ranks[0][f"{arch} serve 2x2"]
    twin = res[0]["twin"]
    assert twin["tokens_equal"] and twin["prefill_err"] <= LOGIT_TOL
    assert twin["first_step_err"] <= twin["limit"]
    assert all(torch.equal(r["tokens"], res[0]["tokens"]) for r in res)


@pytest.mark.parametrize("case", ["qwen2-72b train", "qwen2-72b serve",
                                  "gelu-mlp train", "gelu-mlp serve"])
def test_biases_untied_head_and_gelu_on_mesh_match_one_process(ranks,
                                                               case):
    """QKV biases and an untied lm_head (split over the vocabulary), and
    the plain GeLU MLP (its biases), on (2, 2) against the same work in
    one process (rank 0's twin)."""
    twin = ranks[0][f"{case} 2x2"][0]["twin"]
    if "train" in case:
        assert twin["loss_rel_err"] <= LOSS_RTOL
        assert twin["grads_err_over_limit"] <= 1.0
        assert twin["params"]["worst"] <= 1.0
    else:
        assert twin["tokens_equal"]
        assert twin["prefill_err"] <= LOGIT_TOL
