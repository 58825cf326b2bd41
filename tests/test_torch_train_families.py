"""Training of the RWKV6, Zamba2 and MoE families in the port (CPU)
against the JAX package, at ``reduced()`` sizes in f32, params converted
from the reference's init and the same ``synthetic_stream`` batches:
``RWKV6LM.loss`` and ``Zamba2LM.loss`` and their gradients against
``jax.grad`` of the reference's (the wkv scan through ``WkvScanFn``'s
plain versions; Zamba2's shared block, tied across its applications, one
gradient), remat "full" against "none", one AdamW step against the
reference's jitted step, grad-accum 2 against 1, restarts from disk and
λFS bit-equal, checkpoints and optimizer states crossing between the
packages for each family's tree (the MoE ``mlp`` as [L, E, d, f]), and
``launch.train.main`` for rwkv6-3b, zamba2-1.2b and phi3.5-moe."""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.adamw import AdamWState as JAdamWState  # noqa: E402
from repro.runtime.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core.lambda_fs import LambdaFS  # noqa: E402
from repro_torch.data import synthetic_stream  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import (opt_state_from_jax,  # noqa: E402
                                        opt_state_to_numpy, params_from_jax,
                                        params_to_numpy)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime.train import make_train_step  # noqa: E402

LOSS_RTOL = 1e-5           # f32 both sides; only summation orders differ
GRAD_TOL = 1e-4            # times max(1, max |g_ref|), per leaf
STEP_TOL = dict(atol=2e-5, rtol=2e-4)   # tests/test_train.py's own
# |gradient| above which the first AdamW step, lr g / (|g| + eps), is
# insensitive to a gradient gap at f32 noise (1e-6 x 1e-8 / 1e-10 = 1e-4
# of lr)
WELL_CONDITIONED = 1e-5

SSM_ARCHS = ["rwkv6_3b", "zamba2_1_2b"]
ARCHS = SSM_ARCHS + ["phi3_5_moe_42b_a6_6b"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several test processes
    on the host's cores, and torch's per-process thread pools
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jparams(jmodel, arch):
    """The reference's init as numpy; for RWKV6, seeded noise on its zero
    leaves (token-shift mixes, LoRA and decay up-projections), so the
    data-dependent paths carry weight and a gradient."""
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    if arch == "rwkv6_3b":
        rng = np.random.default_rng(7)
        for blk in ("time_mix", "channel_mix"):
            for name, leaf in jparams["layers"][blk].items():
                if name.startswith("mu_") or name in ("lora_b", "wb"):
                    jparams["layers"][blk][name] = (rng.standard_normal(
                        leaf.shape) * 0.3).astype(np.float32)
    return jparams


@functools.lru_cache(maxsize=None)
def _family(arch):
    """(arch, reference model, its params as numpy, port model, cfg) at
    ``reduced()``, f32, remat "none"."""
    jcfg = jget_arch(arch).reduced()
    jmodel = jget_model(jcfg, compute_dtype=jnp.float32, remat="none")
    jparams = _jparams(jmodel, arch)
    model = get_model(ArchConfig(**dataclasses.asdict(jcfg)),
                      compute_dtype=torch.float32, remat="none")
    return arch, jmodel, jparams, model, jcfg


@pytest.fixture(params=ARCHS)
def fam(request):
    return _family(request.param)


def _batches(cfg, n, batch=4, seq=64, kind="random"):
    return [synthetic_stream(0, i, 0, batch=batch, seq_len=seq,
                             vocab=cfg.vocab_size, kind=kind)
            for i in range(n)]


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


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


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The loss and every leaf's gradient against ``jax.grad`` of the
    reference's loss; Zamba2's shared block (3 applications at
    ``reduced()``) gets one gradient, the sum the reference takes."""
    jcfg = jget_arch(arch).reduced()
    jmodel = jget_model(jcfg, compute_dtype=jnp.float32, remat="none")
    jparams = _jparams(jmodel, arch)
    model = get_model(ArchConfig(**dataclasses.asdict(jcfg)), remat="none")
    batch = _batches(jcfg, 1, batch=2)[0]
    (jl, jparts), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, jparams), _jb(batch))
    loss, parts, grads = _grads(model, params_from_jax(jparams, "cpu"),
                                _tb(batch))
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    assert float(parts["ce"].detach()) == pytest.approx(
        float(jparts["ce"]), rel=LOSS_RTOL)
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0
    n = 0
    for path, want, got in _pairs(jax.device_get(jg), grads):
        lim = GRAD_TOL * max(1.0, float(np.abs(want).max()))
        err = float(np.abs(got - want).max())
        assert err <= lim, (path, err, lim)
        n += 1
    assert n == len(tree_leaves(grads))
    if arch == "zamba2_1_2b":
        assert model.n_attn == 3
        assert float(grads["shared_attn"]["attn"]["wq"].abs().max()) > 0


def test_remat_full_matches_none(fam):
    """Recomputing each layer in the backward pass gives the same loss and
    gradients, bit for bit."""
    arch, _, jparams, _, jcfg = fam
    batch = _tb(_batches(jcfg, 1, batch=2)[0])
    runs = []
    for remat in ("none", "full"):
        m = get_model(ArchConfig(**dataclasses.asdict(jcfg)), remat=remat)
        runs.append(_grads(m, params_from_jax(jparams, "cpu"), batch))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(tree_leaves(runs[0][2]), tree_leaves(runs[1][2])):
        assert torch.equal(a, b)


def _port_step(model, lr, ga=1):
    init_fn, upd_fn = adamw(lr=lr)
    return init_fn, make_train_step(model, upd_fn, grad_accum=ga)


def _step_close(got, want, g_ref, lr, path):
    """Params after one AdamW step, at the reference's tolerance where
    the step is well conditioned.  The first step moves an element by lr
    g / (|g| + eps): where |g| is near eps (1e-8) a gradient gap far
    inside GRAD_TOL turns the update around, so elements whose reference
    gradient is below WELL_CONDITIONED are held to the bound every first
    step keeps, |update| <= lr, on both sides."""
    ok = np.abs(g_ref) >= WELL_CONDITIONED
    np.testing.assert_allclose(got[ok], want[ok], err_msg=path, **STEP_TOL)
    assert float(np.abs(got - want).max()) <= 2 * lr * (1 + 1e-6), path


def test_adamw_step_matches_reference(fam):
    arch, jmodel, jparams, model, jcfg = fam
    batch = _batches(jcfg, 1)[0]
    jinit, jupd = jadamw(lr=3e-3)
    jstep = jax.jit(jmake_train_step(jmodel, jupd))
    jp = jax.tree.map(jnp.asarray, jparams)
    jp1, jo1, jm = jstep(jp, jinit(jp), _jb(batch))
    _, jg = jax.value_and_grad(jmodel.loss, has_aux=True)(jp, _jb(batch))
    init, step = _port_step(model, 3e-3)
    tp = params_from_jax(jparams, "cpu")
    tp1, to1, m = step(tp, init(tp), _tb(batch))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=LOSS_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-4)
    assert int(to1.step) == int(jo1.step) == 1
    grads = dict((path, g) for path, g, _ in _pairs(jax.device_get(jg), tp1))
    for path, want, got in _pairs(jax.device_get(jp1), tp1):
        _step_close(got, want, grads[path], 3e-3, path)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_grad_accum_2_matches_1(arch):
    """ga 2 against ga 1 after one AdamW step, at the reference's own
    tolerance where the step is well conditioned.  (Not the MoE: its aux
    term and capacity are per microbatch, so ga changes its objective.)"""
    _, _, jparams, model, jcfg = _family(arch)
    batch = _tb(_batches(jcfg, 1)[0])
    outs = {}
    for ga in (1, 2):
        init, step = _port_step(model, 3e-3, ga=ga)
        tp = params_from_jax(jparams, "cpu")
        outs[ga] = step(tp, init(tp), batch)
    assert float(outs[1][2]["loss"]) == pytest.approx(
        float(outs[2][2]["loss"]), rel=LOSS_RTOL)
    grads_only = lambda g, s, p: (g, s)
    g1, _, _ = make_train_step(model, grads_only, clip=1e30)(
        params_from_jax(jparams, "cpu"), None, batch)
    grads = {path: g for path, g, _ in _pairs(params_to_numpy(g1), g1)}
    for path, want, got in _pairs(params_to_numpy(outs[1][0]), outs[2][0]):
        _step_close(got, want, grads[path], 3e-3, path)


@pytest.mark.parametrize("store", ["disk", "lambdafs"])
def test_checkpoint_restart_exact(fam, tmp_path, store):
    """Crash/restart: 2 steps, save, restore into a fresh template, 2 more
    steps: bit-identical to 4 uninterrupted."""
    _, _, jparams, model, jcfg = fam
    init, step = _port_step(model, 3e-3)
    batches = [_tb(b) for b in _batches(jcfg, 4, batch=2, seq=32)]
    p = params_from_jax(jparams, "cpu")
    o = init(p)
    for b in batches:
        p, o, _ = step(p, o, b)
    want = [x.clone() for x in tree_leaves(p)]
    mgr = (CheckpointManager(str(tmp_path)) if store == "disk" else
           CheckpointManager("/unused", fs=LambdaFS()))
    p = params_from_jax(jparams, "cpu")
    o = init(p)
    for b in batches[:2]:
        p, o, _ = step(p, o, b)
    mgr.save(2, {"params": p, "opt": o})
    del p, o
    template = params_from_jax(jparams, "cpu")
    state = mgr.restore({"params": template, "opt": init(template)})
    p, o = state["params"], state["opt"]
    assert int(o.step) == 2
    for b in batches[2:]:
        p, o, _ = step(p, o, b)
    for a, w in zip(tree_leaves(p), want):
        assert torch.equal(a, w)


def test_params_and_opt_state_convert_both_ways(fam):
    """``params_from_jax`` / ``params_to_numpy`` and ``opt_state_from_jax``
    / ``opt_state_to_numpy`` round-trip each family's tree bit for bit."""
    arch, _, jparams, _, jcfg = fam
    tp = params_from_jax(jparams, "cpu")
    back = params_to_numpy(tp)
    assert back.keys() == jparams.keys()
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    if arch.startswith("phi3_5"):
        mlp = tp["layers"]["mlp"]["w_gate"]
        assert mlp.shape == (jcfg.n_layers, jcfg.n_experts, jcfg.d_model,
                             jcfg.d_ff)
    jinit, _ = jadamw(lr=1e-3)
    jo = jax.device_get(jinit(jax.tree.map(jnp.asarray, jparams)))
    jo = JAdamWState(np.asarray(3, np.int32),
                     jax.tree.map(lambda x: x + 1, jo.m), jo.v)
    to = opt_state_from_jax(jo, device="cpu")
    assert int(to.step) == 3 and to.step.dtype == torch.int32
    back = JAdamWState(*opt_state_to_numpy(to))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jo)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_checkpoint_crosses_packages(arch, tmp_path):
    """A checkpoint of a trained step written by the reference's manager
    restores into the port, and the port's into the reference."""
    jcfg = jget_arch(arch).reduced()
    jmodel = jget_model(jcfg, compute_dtype=jnp.float32, remat="none")
    jparams = _jparams(jmodel, arch)
    jinit, jupd = jadamw(lr=3e-3)
    jp = jax.tree.map(jnp.asarray, jparams)
    jp, jo, _ = jax.jit(jmake_train_step(jmodel, jupd))(
        jp, jinit(jp), _jb(_batches(jcfg, 1, batch=2, seq=32)[0]))
    JCheckpointManager(str(tmp_path / "ref")).save(1, {"params": jp,
                                                       "opt": jo})
    init, _ = adamw(lr=3e-3)
    template = params_from_jax(jparams, "cpu")
    state = CheckpointManager(str(tmp_path / "ref")).restore(
        {"params": template, "opt": init(template)})
    for path, want, got in _pairs(jax.device_get(jp), state["params"]):
        np.testing.assert_array_equal(got, want, err_msg=path)
    assert int(state["opt"].step) == 1
    CheckpointManager(str(tmp_path / "port")).save(
        1, {"params": state["params"], "opt": state["opt"]})
    jtemplate = {"params": jax.tree.map(jnp.asarray, jparams),
                 "opt": jinit(jax.tree.map(jnp.asarray, jparams))}
    back = JCheckpointManager(str(tmp_path / "port")).restore(jtemplate)
    assert sorted(os.listdir(tmp_path / "ref" / "step_1")) == sorted(
        os.listdir(tmp_path / "port" / "step_1"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
            {"params": jp, "opt": jo})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_train_launcher_on_cpu(arch, tmp_path):
    """``launch.train.main`` trains each family with checkpoints and a
    resume on the CPU when asked."""
    from repro_torch.launch import train
    args = ["--arch", arch, "--reduced", "--steps", "3", "--batch", "4",
            "--seq", "32", "--grad-accum", "2", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2", "--device", "cpu"]
    losses = train.main(args)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert CheckpointManager(str(tmp_path)).steps() == [2, 3]
    assert len(train.main([*args, "--steps", "4", "--resume"])) == 1
