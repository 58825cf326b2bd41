"""The port's training slice (CPU) against the JAX package: reduced
granite-3-2b in f32 without remat, params converted from the reference's
init, the same ``synthetic_stream`` batches.  Loss, gradients, one AdamW
step, the schedule and the clip, grad accumulation and compression
against the reference; the reference's own training cases
(``tests/test_train.py``) on the port; checkpoints across the two
packages; the ``Model`` facade, the launcher and the quickstart."""
import dataclasses
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.data.pipeline import synthetic_stream as jsynthetic_stream  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import clip_by_global_norm as jclip  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import warmup_cosine as jwarmup_cosine  # noqa: E402
from repro.optim.adamw import AdamWState as JAdamWState  # noqa: E402
from repro.runtime.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import (ARCH_IDS, ArchConfig,  # noqa: E402
                                      ShapeConfig, get_arch)
from repro_torch.core.lambda_fs import LambdaFS  # noqa: E402
from repro_torch.data import ShardedLoader, synthetic_stream  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.api import Model, get_model  # noqa: E402
from repro_torch.models.convert import (opt_state_from_jax,  # noqa: E402
                                        opt_state_to_numpy, params_from_jax,
                                        params_to_numpy)
from repro_torch.optim import adamw, clip_by_global_norm, warmup_cosine  # noqa: E402
from repro_torch.optim import compression as comp  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime.train import make_train_step  # noqa: E402

LOSS_RTOL = 1e-5           # f32 both sides; only summation orders differ
GRAD_TOL = 1e-4            # times max(1, max |g_ref|), per leaf
STEP_TOL = dict(atol=2e-5, rtol=2e-4)   # tests/test_train.py's own


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several test processes
    on the host's cores, and torch's per-process thread pools
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """(reference model, its params as numpy, port model, cfg)."""
    jcfg = jget_arch("granite_3_2b").reduced()
    jmodel = jget_model(jcfg, compute_dtype=jnp.float32, remat="none")
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    model = get_model(ArchConfig(**dataclasses.asdict(jcfg)),
                      compute_dtype=torch.float32, remat="none")
    return jmodel, jparams, model, jcfg


def _np_batches(cfg, n, batch=8, seq=32, kind="learnable"):
    return [synthetic_stream(0, i, 0, batch=batch, seq_len=seq,
                             vocab=cfg.vocab_size, kind=kind)
            for i in range(n)]


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _tparams(jparams):
    return params_from_jax(jparams, device="cpu")


def _pairs(jtree, ttree, path=""):
    if isinstance(ttree, dict):
        for k in ttree:
            yield from _pairs(jtree[k], ttree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(jtree), ttree.detach().numpy()


def _grads(model, params, batch):
    p = tree_map(lambda x: x.detach().clone().requires_grad_(True), params)
    loss, parts = model.loss(p, batch)
    loss.backward()
    return loss.detach(), parts, tree_map(lambda x: x.grad, p)


# -- the data pipeline --------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "learnable"])
def test_synthetic_stream_bit_equal_to_reference(kind):
    for seed, step, shard in ((0, 0, 0), (3, 17, 2)):
        got = synthetic_stream(seed, step, shard, batch=4, seq_len=9,
                               vocab=101, kind=kind)
        want = jsynthetic_stream(seed, step, shard, batch=4, seq_len=9,
                                 vocab=101, kind=kind)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_straggler_backup_fetch():
    calls = {"n": 0}

    def slow_once(step):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.4)
        return synthetic_stream(0, step, 0, batch=2, seq_len=4, vocab=11)

    loader = ShardedLoader(global_batch=2, seq_len=4, vocab=11, n_shards=1,
                           shard=0, fetch_fn=slow_once, backup_after_ms=30)
    batch = next(loader)
    assert batch["tokens"].shape == (2, 4)
    assert loader.stats["backups_issued"] >= 1
    loader.close()


def test_reshard_keeps_the_stream():
    loader = ShardedLoader(global_batch=4, seq_len=5, vocab=13, n_shards=1,
                           shard=0, seed=2)
    first = next(loader)
    half = loader.reshard(2, 1)
    got = next(half)
    half.close()
    np.testing.assert_array_equal(got["tokens"], synthetic_stream(
        2, 0, 1, batch=2, seq_len=5, vocab=13)["tokens"])
    assert first["tokens"].shape == (4, 5)


# -- loss, gradients, one step ------------------------------------------------


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(-1, 50, (3, 7)).astype(np.int32)
    want = float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(L.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=LOSS_RTOL)


@pytest.mark.parametrize("seq", [32, 40])       # 40: not a chunk multiple
def test_loss_and_grads_match_reference(setup, seq):
    jmodel, jparams, model, cfg = setup
    jmodel = jget_model(cfg, compute_dtype=jnp.float32, remat="none",
                        loss_chunk=16)
    model = get_model(ArchConfig(**dataclasses.asdict(cfg)), remat="none",
                      loss_chunk=16)
    batch = _np_batches(cfg, 1, batch=4, seq=seq, kind="random")[0]
    (jl, jparts), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, jparams), _jb(batch))
    loss, parts, grads = _grads(model, _tparams(jparams), _tb(batch))
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    assert float(parts["ce"].detach()) == pytest.approx(float(jparts["ce"]),
                                               rel=LOSS_RTOL)
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0
    n = 0
    for path, want, got in _pairs(jax.device_get(jg), grads):
        lim = GRAD_TOL * max(1.0, float(np.abs(want).max()))
        err = float(np.abs(got - want).max())
        assert err <= lim, (path, err, lim)
        n += 1
    assert n == len(tree_leaves(grads))


def test_remat_full_matches_none(setup):
    """Recomputing each layer and loss chunk in the backward pass gives
    the same loss and gradients, bit for bit."""
    _, jparams, _, cfg = setup
    batch = _tb(_np_batches(cfg, 1, batch=2, seq=32)[0])
    pcfg = get_arch("granite_3_2b").reduced()
    runs = []
    for remat in ("none", "full"):
        m = get_model(pcfg, remat=remat, loss_chunk=8)
        runs.append(_grads(m, _tparams(jparams), batch))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(tree_leaves(runs[0][2]), tree_leaves(runs[1][2])):
        assert torch.equal(a, b)


def _port_step(model, lr, ga=1, compression="none"):
    init_fn, upd_fn = adamw(lr=lr)
    return init_fn, make_train_step(model, upd_fn, grad_accum=ga,
                                    compression=compression)


def _ref_step(jmodel, lr, ga=1):
    init_fn, upd_fn = jadamw(lr=lr)
    return init_fn, jax.jit(jmake_train_step(jmodel, upd_fn, grad_accum=ga))


def test_adamw_step_matches_reference(setup):
    jmodel, jparams, model, cfg = setup
    batch = _np_batches(cfg, 1)[0]
    jinit, jstep = _ref_step(jmodel, jwarmup_cosine(3e-3, 2, 10))
    jp = jax.tree.map(jnp.asarray, jparams)
    jp1, jo1, jm = jstep(jp, jinit(jp), _jb(batch))
    init, step = _port_step(model, warmup_cosine(3e-3, 2, 10))
    tp = _tparams(jparams)
    tp1, to1, m = step(tp, init(tp), _tb(batch))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=LOSS_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-4)
    assert int(to1.step) == int(jo1.step) == 1
    for path, want, got in _pairs(jax.device_get(jp1), tp1):
        np.testing.assert_allclose(got, want, err_msg=path, **STEP_TOL)
    # the moments carry the gradients' gap, scaled by 1 - b1 (m) and
    # 1 - b2 times 2|g| (v)
    for tree, jtree in ((to1.m, jo1.m), (to1.v, jo1.v)):
        for path, want, got in _pairs(jax.device_get(jtree), tree):
            np.testing.assert_allclose(got, want, err_msg=path, rtol=2e-4,
                                       atol=0.1 * GRAD_TOL)


def test_schedule_and_clip_match_reference():
    js = jwarmup_cosine(3e-3, 5, 20)
    ts = warmup_cosine(3e-3, 5, 20)
    for step in range(21):
        want = float(js(jnp.asarray(step, jnp.int32)))
        got = float(ts(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-7, (step, got, want)
    rng = np.random.default_rng(1)
    grads = {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    for max_norm in (0.5, 100.0):        # clipped, and left as it is
        jg, jn = jclip(jax.tree.map(jnp.asarray, grads), max_norm)
        tg, tn = clip_by_global_norm(params_from_jax(grads, "cpu"),
                                     max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        for path, want, got in _pairs(jax.device_get(jg), tg):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_grad_accum_matches_ga1_and_reference(setup):
    """ga 4 against ga 1 after one AdamW step (the reference's own check,
    at its tolerance), and the gradients ga 4 accumulates against the
    reference's ga 4 (its microbatch split): each step's ``opt_update``
    returns the unclipped gradients as the params.  (After one AdamW
    step, an element whose gradient is near eps moves by up to 2 lr on
    a small gap: the first step is g / (|g| + eps).)"""
    jmodel, jparams, model, cfg = setup
    batch = _np_batches(cfg, 1, batch=8, seq=32)[0]
    outs = {}
    for ga in (1, 4):
        init, step = _port_step(model, 3e-3, ga=ga)
        tp = _tparams(jparams)
        outs[ga] = step(tp, init(tp), _tb(batch))
    for a, b in zip(tree_leaves(outs[1][0]), tree_leaves(outs[4][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **STEP_TOL)

    grads_only = lambda g, s, p: (g, s)
    grads = {}
    for ga in (1, 4):
        step = make_train_step(model, grads_only, grad_accum=ga, clip=1e30)
        grads[ga], _, m = step(_tparams(jparams), None, _tb(batch))
    jstep = jax.jit(jmake_train_step(jmodel, grads_only, grad_accum=4,
                                     clip=1e30))
    jg, _, jm = jstep(jax.tree.map(jnp.asarray, jparams), None, _jb(batch))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                              rel=LOSS_RTOL)
    for want_tree in (jax.device_get(jg), params_to_numpy(grads[1])):
        for path, want, got in _pairs(want_tree, grads[4]):
            lim = GRAD_TOL * max(1.0, float(np.abs(want).max()))
            assert float(np.abs(got - want).max()) <= lim, path


def test_microbatch_split_is_the_references():
    from repro_torch.runtime.train import _split
    x = np.arange(8 * 3).reshape(8, 3)
    r = np.moveaxis(x.reshape(2, 4, 3), 1, 0)
    np.testing.assert_array_equal(_split(torch.from_numpy(x), 4).numpy(), r)
    with pytest.raises(ValueError, match="multiple"):
        _split(torch.zeros(6, 2), 4)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_compress_grads_matches_reference(mode):
    rng = np.random.default_rng(2)
    grads = {"w": rng.standard_normal((3, 5, 7)).astype(np.float32),
             "b": {"v": (rng.standard_normal(9) * 1e-3).astype(np.float32)},
             "z": np.zeros((2, 4), np.float32)}
    res = tree_map(lambda g: (rng.standard_normal(g.shape) * 1e-2)
                   .astype(np.float32), grads)
    jdec, jres = jcomp.compress_grads(jax.tree.map(jnp.asarray, grads),
                                      jax.tree.map(jnp.asarray, res), mode)
    dec, new_res = comp.compress_grads(params_from_jax(grads, "cpu"),
                                       params_from_jax(res, "cpu"), mode)
    for jt, tt in ((jdec, dec), (jres, new_res)):
        for path, want, got in _pairs(jax.device_get(jt), tt):
            np.testing.assert_array_equal(got, want, err_msg=path)
    tp = params_from_jax(grads, "cpu")
    for m in ("none", "bf16", "int8"):
        assert comp.compressed_bytes(tp, m) == jcomp.compressed_bytes(
            jax.tree.map(jnp.asarray, grads), m)
    zero = comp.init_residuals(tp)
    assert all(float(t.abs().sum()) == 0 for t in tree_leaves(zero))


# -- the reference's training cases, on the port ------------------------------


def test_loss_decreases_on_learnable_data(setup):
    _, jparams, model, cfg = setup
    init, step = _port_step(model, 3e-3)
    p = _tparams(jparams)
    opt = init(p)
    losses = []
    for batch in _np_batches(cfg, 40):
        p, opt, m = step(p, opt, _tb(batch))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.6, losses[::10]


def test_compression_training_runs(setup):
    _, jparams, model, cfg = setup
    init, step = _port_step(model, 3e-3, compression="int8")
    p = _tparams(jparams)
    opt, res = init(p), comp.init_residuals(p)
    losses = []
    for batch in _np_batches(cfg, 25):
        p, opt, res, m = step(p, opt, res, _tb(batch))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("store", ["disk", "lambdafs"])
def test_checkpoint_restart_exact(setup, tmp_path, store):
    """Crash/restart: resumed training is bit-identical to uninterrupted,
    from a directory and from λFS."""
    _, jparams, model, cfg = setup
    init, step = _port_step(model, 3e-3)
    batches = [_tb(b) for b in _np_batches(cfg, 8)]

    p = _tparams(jparams)
    o = init(p)
    for b in batches:
        p, o, _ = step(p, o, b)
    ref_leaves = [x.clone() for x in tree_leaves(p)]

    mgr = (CheckpointManager(str(tmp_path)) if store == "disk" else
           CheckpointManager("/unused", fs=LambdaFS()))
    p = _tparams(jparams)
    o = init(p)
    for b in batches[:4]:
        p, o, _ = step(p, o, b)
    mgr.save(4, {"params": p, "opt": o})
    del p, o
    template = _tparams(jparams)
    state = mgr.restore({"params": template, "opt": init(template)})
    p, o = state["params"], state["opt"]
    assert int(o.step) == 4 and o.step.dtype == torch.int32
    for b in batches[4:]:
        p, o, _ = step(p, o, b)
    for a, r in zip(tree_leaves(p), ref_leaves):
        assert torch.equal(a, r)


def test_checkpoint_async_and_atomic(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 3))}}
    for step in (1, 2, 3):
        mgr.save(step, tree, blocking=False)
    mgr.wait()
    assert mgr.steps() == [2, 3]            # GC keeps 2
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    out = mgr.restore(tree, step=3)
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])


class _GatedFS(LambdaFS):
    """λFS whose writes wait until ``gate`` is set: an async save's
    writes then run after whatever the caller does next."""

    def __init__(self):
        super().__init__()
        self.gate = threading.Event()

    def write(self, *args, **kw):
        self.gate.wait()
        return super().write(*args, **kw)


def test_checkpoint_async_save_is_a_snapshot(setup):
    """An async save writes the state of its step, even when the next
    train step updates params and moments in place before the write."""
    _, jparams, model, cfg = setup
    init, step = _port_step(model, 3e-3)
    b0, b1 = (_tb(b) for b in _np_batches(cfg, 2))
    p = _tparams(jparams)
    o = init(p)
    p, o, _ = step(p, o, b0)

    def leaves(p, o):
        return tree_leaves(p) + [o.step] + tree_leaves(o.m) + tree_leaves(o.v)

    saved = [x.clone() for x in leaves(p, o)]
    fs = _GatedFS()
    mgr = CheckpointManager("/unused", fs=fs)
    mgr.save(1, {"params": p, "opt": o}, blocking=False)
    p, o, _ = step(p, o, b1)                  # in place, before the write
    fs.gate.set()
    mgr.wait()
    template = _tparams(jparams)
    out = mgr.restore({"params": template, "opt": init(template)})
    got = leaves(out["params"], out["opt"])
    assert len(got) == len(saved)
    for a, w in zip(got, saved):
        assert torch.equal(a, w)
    # the second step did change the tree the save was given
    assert not all(torch.equal(a, w) for a, w in zip(leaves(p, o), saved))


def test_checkpoint_into_lambdafs():
    fs = LambdaFS()
    mgr = CheckpointManager("/unused", fs=fs)
    tree = {"w": torch.ones((4, 4)), "step": torch.tensor(7)}
    mgr.save(11, tree)
    assert mgr.latest_step() == 11
    out = mgr.restore(tree)
    assert torch.equal(out["w"], torch.ones((4, 4)))
    assert int(out["step"]) == 7
    assert fs.exists("/ckpt/step_11/COMMITTED")


def test_checkpoint_crosses_packages(setup, tmp_path):
    """A checkpoint the reference's manager writes restores into the
    port, and the port's into the reference: the same keys, files and
    manifest layout."""
    jmodel, jparams, model, cfg = setup
    jinit, jstep = _ref_step(jmodel, 3e-3)
    jp = jax.tree.map(jnp.asarray, jparams)
    jp, jo, _ = jstep(jp, jinit(jp), _jb(_np_batches(cfg, 1)[0]))
    JCheckpointManager(str(tmp_path / "ref")).save(1, {"params": jp,
                                                       "opt": jo})
    init, _ = _port_step(model, 3e-3)
    template = _tparams(jparams)
    state = CheckpointManager(str(tmp_path / "ref")).restore(
        {"params": template, "opt": init(template)})
    for path, want, got in _pairs(jax.device_get(jp), state["params"]):
        np.testing.assert_array_equal(got, want, err_msg=path)
    assert int(state["opt"].step) == 1
    for path, want, got in _pairs(jax.device_get(jo.m), state["opt"].m):
        np.testing.assert_array_equal(got, want, err_msg=path)

    CheckpointManager(str(tmp_path / "port")).save(
        1, {"params": state["params"], "opt": state["opt"]})
    jtemplate = {"params": jax.tree.map(jnp.asarray, jparams),
                 "opt": jinit(jax.tree.map(jnp.asarray, jparams))}
    back = JCheckpointManager(str(tmp_path / "port")).restore(jtemplate)
    names = sorted(os.listdir(tmp_path / "ref" / "step_1"))
    assert names == sorted(os.listdir(tmp_path / "port" / "step_1"))
    assert int(back["opt"].step) == 1
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
            {"params": jp, "opt": jo})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_opt_state_converts_both_ways(setup):
    jmodel, jparams, _, _ = setup
    jinit, _ = jadamw(lr=1e-3)
    jo = jax.device_get(jinit(jax.tree.map(jnp.asarray, jparams)))
    jo = JAdamWState(np.asarray(5, np.int32),
                     jax.tree.map(lambda x: x + 1, jo.m), jo.v)
    to = opt_state_from_jax(jo, device="cpu")
    assert int(to.step) == 5 and to.step.dtype == torch.int32
    back = JAdamWState(*opt_state_to_numpy(to))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jo)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert params_to_numpy(to.m).keys() == jparams.keys()


# -- the facade, the launcher, the quickstart ---------------------------------


def test_model_facade():
    cfg = get_arch("granite_3_2b").reduced()
    m = get_model(cfg, compute_dtype=torch.float32, remat="none",
                  q_chunk=64, moe_no_drop=True)     # options it does not take
    assert isinstance(m, Model) and m.cfg is cfg and m.remat == "none"
    assert m.compute_dtype is torch.float32 and not m.uses_embeds()
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    assert m.param_count(p) == m.active_param_count(p) == sum(
        t.numel() for t in tree_leaves(p))
    b = m.synth_batch(ShapeConfig("t", 8, 2, "train"))
    assert b["tokens"].shape == (2, 8) and torch.equal(b["tokens"],
                                                        b["labels"])
    loss, _ = m.loss(p, b)
    assert torch.isfinite(loss)
    d = m.synth_batch(ShapeConfig("d", 8, 2, "decode"))
    assert d["tokens"].shape == (2,) and d["cache"]["index"] == 0
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_model(cfg, remat="dots")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_has_a_loss(arch):
    """The facade's ``loss`` of every registry arch at ``reduced()`` (a
    frontend arch on its synthetic embeddings) is a finite f32 scalar,
    with its gradient: no family raises."""
    m = get_model(get_arch(arch).reduced(), remat="none")
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    batch = m.synth_batch(ShapeConfig("t", 16, 2, "train"))
    w = p["final_norm"]["scale"].requires_grad_(True)
    loss, parts = m.loss(p, batch)
    assert loss.shape == () and loss.dtype == torch.float32
    assert torch.isfinite(loss) and set(parts) == {"ce", "aux"}
    loss.backward()
    assert torch.isfinite(w.grad).all()


def test_train_launcher_runs_on_cpu_when_asked(tmp_path):
    from repro_torch.launch import train
    args = ["--arch", "granite-3-2b", "--reduced", "--steps", "4",
            "--batch", "4", "--seq", "16", "--grad-accum", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--device", "cpu"]
    losses = train.main(args)
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert CheckpointManager(str(tmp_path)).steps() == [2, 4]
    assert len(train.main([*args, "--steps", "5", "--resume"])) == 1
    assert CheckpointManager(str(tmp_path)).steps() == [2, 4, 5]


def test_launcher_build_is_what_main_trains():
    """``launch.train.build`` gives the objects ``main`` trains with (the
    smoke's train phase takes them from there): its step on the loader's
    batches reproduces main's losses bit for bit; ``cfg=`` stands in for
    the arch's config."""
    from repro_torch.launch import train
    argv = ["--arch", "granite-3-2b", "--reduced", "--steps", "3",
            "--batch", "4", "--seq", "16", "--grad-accum", "2",
            "--device", "cpu"]
    losses = train.main(argv)
    run = train.build(train.parse_args(argv))
    loader = ShardedLoader(global_batch=4, seq_len=16,
                           vocab=run.cfg.vocab_size, n_shards=1, shard=0)
    got, p, o = [], run.params, run.opt_state
    try:
        for _ in range(3):
            p, o, m = run.step(p, o, train.to_device(next(loader), "cpu"))
            got.append(float(m["loss"]))
    finally:
        loader.close()
    assert got == losses
    cut = dataclasses.replace(run.cfg, n_layers=1)
    run = train.build(train.parse_args(argv), cfg=cut)
    assert run.model.cfg.n_layers == 1
    assert run.params["layers"]["attn_norm"]["scale"].shape[0] == 1


def test_train_launcher_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would run on it")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "granite-3-2b", "--reduced", "--steps", "1"])


def test_quickstart_runs_on_cpu(tmp_path):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # past the 20 warm-up steps of its schedule
    first, last = mod.main(["--steps", "21", "--device", "cpu",
                            "--ckpt", str(tmp_path)])
    assert last < first
