"""``remat="dots"`` in the port (CPU) against the JAX package.

The reference's ``"dots"`` is ``jax.checkpoint_policies.
checkpoint_dots_with_no_batch_dims`` (``TransformerLM._maybe_remat``); the
port's is a ``torch.utils.checkpoint`` selective-checkpoint policy
(``models.transformer.dots_policy``).  Held here: the products the port's
policy keeps for one reduced granite layer and one reduced phi3.5-moe
layer against the residuals JAX saves for the same layer
(``saved_residuals``), as multisets of (element count, last dim), the
same sets exactly; the loss and gradients under ``"dots"`` bit-equal to
``"full"`` and ``"none"`` for granite, phi3.5-moe, RWKV6 and Zamba2 (the
last two treat ``"dots"`` as ``"full"``, as the reference does); granite's
loss and gradients under ``"dots"`` against ``jax.grad`` of the
reference's; and a ``"dots"`` train step through ``make_train_step``."""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax._src.ad_checkpoint import saved_residuals  # noqa: E402
from torch.utils.checkpoint import (checkpoint,  # noqa: E402
                                    create_selective_checkpoint_contexts)

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.data import synthetic_stream  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim.adamw import adamw  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime.train import make_train_step  # noqa: E402

LOSS_RTOL = 1e-5           # f32 both sides; only summation orders differ
GRAD_RTOL = 1e-5           # times max |g_ref|, per leaf

B, S = 2, 64


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return ArchConfig(**dataclasses.asdict(jget_arch(arch).reduced()))


def _jparams(arch):
    jm = jget_model(jget_arch(arch).reduced(), compute_dtype=jnp.float32,
                    remat="none")
    return jm, jax.device_get(jm.init(jax.random.PRNGKey(0)))


def _batch(cfg, batch=B, seq=32):
    b = synthetic_stream(0, 0, 0, batch=batch, seq_len=seq,
                         vocab=cfg.vocab_size, kind="random")
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _grads(model, params, batch):
    p = tree_map(lambda x: x.detach().clone().requires_grad_(True), params)
    loss, _ = model.loss(p, batch)
    loss.backward()
    return loss.detach(), [t.grad for t in tree_leaves(p)]


def _layer_inputs(arch="granite_3_2b"):
    """One reduced layer's params (layer 0 of the reference's init) and a
    seeded input h [B, S, d], as numpy."""
    jm, jp = _jparams(arch)
    lp = jax.tree.map(lambda x: np.asarray(x[0]), jp["layers"])
    h = np.random.default_rng(1).standard_normal(
        (B, S, jm.cfg.d_model)).astype(np.float32)
    return jm, lp, h


def _reference_saved(jm, lp, h):
    """(element count, last dim) of each residual the reference's dots
    policy saves for one layer: the outputs of its products, not the
    layer's arguments or constants."""
    pos = jnp.arange(S, dtype=jnp.int32)[None].repeat(B, 0)
    fn = jax.checkpoint(
        lambda hh, p: jm.impl._layer(hh, p, pos),
        policy=jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims)
    res = saved_residuals(fn, jnp.asarray(h),
                          jax.tree.map(jnp.asarray, lp))
    return [(int(np.prod(a.shape)), a.shape[-1]) for a, why in res
            if not why.startswith(("from the argument", "from a constant"))]


def _port_saved(lp, h, policy=T.dots_policy, arch="granite_3_2b"):
    """(element count, last dim) of each output the port's policy keeps
    for one layer, and the op of each, from a policy that records what
    it is asked; the layer runs forward and backward."""
    saved, ops_seen = [], []

    def recording(ctx, func, *args, **kwargs):
        decision = policy(ctx, func, *args, **kwargs)
        if ctx.is_recompute:
            return decision
        ops_seen.append(func)
        if decision == T.CheckpointPolicy.MUST_SAVE:
            a, w = args[-2], args[-1]            # mm(a, w), addmm(bias, a, w)
            saved.append((a.shape[0] * w.shape[1], w.shape[1]))
        return decision

    model = get_model(_cfg(arch), remat="dots")
    tlp = {k: tree_map(lambda x: torch.from_numpy(np.array(x))
                       .requires_grad_(True), v) for k, v in lp.items()}
    th = torch.from_numpy(h).requires_grad_(True)
    out, _ = checkpoint(model._train_layer, th, tlp, use_reentrant=False,
                        context_fn=lambda: create_selective_checkpoint_contexts(
                            recording))
    out.sum().backward()
    return saved, ops_seen


@pytest.mark.parametrize("arch,n", [("granite_3_2b", 6),
                                    ("phi3_5_moe_42b_a6_6b", 5)])
def test_dots_saved_set_is_the_references(arch, n):
    """The port keeps exactly the reference's saved products: q, k, v, the
    output projection, and the gate and up products (granite) or the
    router's logits (the MoE).  The FFN's down product (its output no
    backward rule reads) and the MoE experts' products (batched einsums
    in the reference) run under ``layers.unsaved`` and are recomputed."""
    jm, lp, h = _layer_inputs(arch)
    want = collections.Counter(_reference_saved(jm, lp, h))
    got, _ = _port_saved(lp, h, arch=arch)
    assert collections.Counter(got) == want, (got, want)
    assert sum(want.values()) == n


def test_dots_policy_sees_every_projection_as_mm():
    """Each projection of the layer reaches the dispatcher as one 2-D
    ``aten.mm`` (a 3-D ``x @ W`` folds when it needs a gradient), every
    one kept but the FFN's down product; the attention's products,
    batched, are not kept."""
    _, lp, h = _layer_inputs()
    saved, ops_seen = _port_saved(lp, h)
    mm = torch.ops.aten.mm.default
    assert sum(op == mm for op in ops_seen) == len(saved) + 1 == 7
    assert torch.ops.aten.bmm.default in ops_seen


def test_full_policy_saves_nothing_of_the_layer():
    """Under a policy that keeps nothing (``"full"``'s behaviour) the same
    recording sees the same ops and saves none."""
    _, lp, h = _layer_inputs()
    saved, ops_seen = _port_saved(
        lp, h, policy=lambda *a, **k: T.CheckpointPolicy.PREFER_RECOMPUTE)
    assert saved == [] and torch.ops.aten.mm.default in ops_seen


@pytest.mark.parametrize("arch", ["granite_3_2b", "phi3_5_moe_42b_a6_6b",
                                  "rwkv6_3b", "zamba2_1_2b"])
def test_dots_bit_equal_to_full_and_none(arch):
    """Loss and every gradient under ``"dots"`` equal ``"full"`` and
    ``"none"``'s bit for bit: what is kept does not change what is
    computed."""
    _, jp = _jparams(arch)
    cfg = _cfg(arch)
    batch = _batch(cfg)
    runs = {}
    for remat in ("none", "full", "dots"):
        m = get_model(cfg, remat=remat, **({"loss_chunk": 8} if arch in (
            "granite_3_2b", "phi3_5_moe_42b_a6_6b") else {}))
        assert m.remat == remat
        runs[remat] = _grads(m, params_from_jax(jp, "cpu"), batch)
    for other in ("none", "full"):
        assert torch.equal(runs["dots"][0], runs[other][0])
        for a, b in zip(runs["dots"][1], runs[other][1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("seq", [32, 40])       # 40: not a chunk multiple
def test_granite_dots_against_jax_grad(seq):
    """Granite's loss and gradients under ``"dots"`` on both sides, within
    1e-5 rel: the loss, and each gradient leaf to 1e-5 of its largest
    element."""
    jcfg = jget_arch("granite_3_2b").reduced()
    jm = jget_model(jcfg, compute_dtype=jnp.float32, remat="dots",
                    loss_chunk=16)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    model = get_model(_cfg("granite_3_2b"), remat="dots", loss_chunk=16)
    nb = synthetic_stream(0, 0, 0, batch=4, seq_len=seq,
                          vocab=jcfg.vocab_size, kind="random")
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in nb.items()})
    loss, grads = _grads(model, params_from_jax(jp, "cpu"),
                         {k: torch.from_numpy(v).long()
                          for k, v in nb.items()})
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    wants = jax.tree_util.tree_leaves(jax.device_get(jg))
    assert len(wants) == len(grads)
    tp = params_from_jax(jax.device_get(jg), "cpu")
    for want, got in zip(tree_leaves(tp), grads):
        want = want.numpy()
        lim = GRAD_RTOL * float(np.abs(want).max())
        assert float(np.abs(got.numpy() - want).max()) <= lim


def test_dots_train_step_equals_full():
    """Two AdamW steps of reduced granite through ``make_train_step``
    under ``"dots"`` and ``"full"``: the same params, bit for bit."""
    _, jp = _jparams("granite_3_2b")
    cfg = _cfg("granite_3_2b")
    out = {}
    for remat in ("full", "dots"):
        m = get_model(cfg, remat=remat, loss_chunk=8)
        params = params_from_jax(jp, "cpu")
        init_fn, upd_fn = adamw(lr=1e-3)
        opt = init_fn(params)
        step = make_train_step(m, upd_fn)
        for i in range(2):
            b = synthetic_stream(0, i, 0, batch=2, seq_len=32,
                                 vocab=cfg.vocab_size, kind="learnable")
            params, opt, _ = step(params, opt, {
                k: torch.from_numpy(v).long() for k, v in b.items()})
        out[remat] = tree_leaves(params)
    for a, b in zip(out["full"], out["dots"]):
        assert torch.equal(a, b)


def test_train_launcher_takes_remat_dots():
    """``launch.train --remat dots`` builds a "dots" model and trains;
    the default stays "none" at ``--reduced``; ``--remat full`` is
    taken too."""
    from repro_torch.launch import train as ltrain
    args = ["--arch", "granite-3-2b", "--reduced", "--steps", "2",
            "--batch", "2", "--seq", "16", "--device", "cpu"]
    run = ltrain.build(ltrain.parse_args(args + ["--remat", "dots"]))
    assert run.model.remat == "dots"
    assert ltrain.build(ltrain.parse_args(args)).model.remat == "none"
    assert ltrain.build(ltrain.parse_args(
        args + ["--remat", "full"])).model.remat == "full"
    losses = ltrain.main(args + ["--remat", "dots", "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))
