"""The frontend archs and the ``Model`` facade across every arch (CPU),
against the JAX package on the same converted weights and numpy inputs:
paligemma-3b ``forward``, ``prefill`` and ``loss`` on precomputed patch
embeddings, hubert-xlarge's bidirectional encoder, ``synth_batch`` and
``synth_embeddings``, ``active_param_count``, and the reference's
``test_prefill_decode_matches_forward`` on the port for every arch with
a decode step."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ARCH_IDS  # noqa: E402
from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro_torch.configs.base import ArchConfig, ShapeConfig  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.models import frontends  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

# f32 on both sides; only summation orders differ
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
DECODE_TOL = 5e-4        # the reference's test_prefill_decode_matches_forward


def _port_cfg(jcfg):
    return ArchConfig(**dataclasses.asdict(jcfg))


def _np(t):
    return t.detach().numpy()


def _models(arch, **kw):
    jcfg = jget_arch(arch).reduced()
    jm = jget_model(jcfg, compute_dtype=jnp.float32, **kw)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm = get_model(_port_cfg(jcfg), **kw)
    return jcfg, (jm, jax.tree.map(jnp.asarray, jp)), (
        tm, params_from_jax(jp, device="cpu"))


def _embeds(cfg, b, s, seed=0):
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_the_jax_registry(arch):
    assert (dataclasses.asdict(get_arch(arch)) ==
            dataclasses.asdict(jget_arch(arch)))


@pytest.mark.parametrize("arch", ["paligemma_3b", "hubert_xlarge"])
def test_frontend_forward_matches_jax(arch):
    jcfg, (jm, jp), (tm, tp) = _models(arch)
    e = _embeds(jcfg, 2, 16)
    want, _ = jm.forward(jp, {"embeds": jnp.asarray(e)})
    got, aux = tm.forward(tp, {"embeds": torch.from_numpy(e)})
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert float(aux) == 0.0


def test_paligemma_prefill_on_embeds_then_tokens_match_jax():
    """Prefill from patch embeddings, then token decode steps, against
    the reference."""
    jcfg, (jm, jp), (tm, tp) = _models("paligemma_3b")
    e = _embeds(jcfg, 2, 12, seed=1)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 4),
                                             dtype=np.int32)
    want, jc = jm.prefill(jp, {"embeds": jnp.asarray(e)},
                          cache_dtype=jnp.float32)
    got, tc = tm.prefill(tp, {"embeds": torch.from_numpy(e)},
                         cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    assert tc["index"] == int(jc["index"]) == 12
    pad = [(0, 0)] * 3 + [(0, 4), (0, 0)]
    jc = {**jc, "k": jnp.pad(jc["k"], pad), "v": jnp.pad(jc["v"], pad)}
    tc = {**tc, "k": torch.nn.functional.pad(tc["k"], (0, 0, 0, 4)),
          "v": torch.nn.functional.pad(tc["v"], (0, 0, 0, 4))}
    for t in range(4):
        want, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t]))
        got, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_paligemma_loss_on_embeds_matches_jax():
    jcfg, (jm, jp), (tm, tp) = _models("paligemma_3b")
    e = _embeds(jcfg, 2, 16, seed=3)
    labels = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 16),
                                               dtype=np.int32)
    labels[:, -1] = -1
    want, jparts = jm.loss(jp, {"embeds": jnp.asarray(e),
                                "labels": jnp.asarray(labels)})
    got, parts = tm.loss(tp, {"embeds": torch.from_numpy(e),
                              "labels": torch.from_numpy(labels).long()})
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["ce"]), float(jparts["ce"]),
                               rtol=LOSS_RTOL)


def test_hubert_bidirectional():
    """Encoder-only: changing the last frame moves the first logits."""
    cfg = get_arch("hubert_xlarge").reduced()
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    e1 = frontends.synth_embeddings(cfg, 1, 16,
                                    torch.Generator().manual_seed(1))
    e2 = e1.clone()
    e2[:, -1] = 0.0
    l1, _ = model.forward(params, {"embeds": e1})
    l2, _ = model.forward(params, {"embeds": e2})
    assert float((l1[:, 0] - l2[:, 0]).abs().max()) > 1e-6


def test_synth_embeddings_and_batch():
    cfg = get_arch("paligemma_3b").reduced()
    model = get_model(cfg)
    assert model.uses_embeds()
    e = frontends.synth_embeddings(cfg, 2, 8)
    assert e.shape == (2, 8, cfg.d_model) and e.dtype == torch.float32
    assert torch.equal(e, frontends.synth_embeddings(cfg, 2, 8))
    assert 0.01 < float(e.std()) < 0.03                 # 0.02 * N(0, 1)
    half = frontends.synth_embeddings(cfg, 2, 8, dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    train = model.synth_batch(ShapeConfig("t", 8, 2, "train"))
    assert set(train) == {"embeds", "labels"}
    assert train["embeds"].shape == (2, 8, cfg.d_model)
    assert train["labels"].shape == (2, 8)
    assert set(model.synth_batch(ShapeConfig("p", 8, 2, "prefill"))) == {
        "embeds"}
    dec = model.synth_batch(ShapeConfig("d", 8, 2, "decode"))
    assert dec["tokens"].shape == (2,) and dec["cache"]["index"] == 0
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    loss, _ = model.loss(params, train)
    assert torch.isfinite(loss)
    text = get_model(get_arch("granite_3_2b").reduced())
    assert set(text.synth_batch(ShapeConfig("t", 8, 2, "train"))) == {
        "tokens", "labels"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_jax(arch):
    jcfg, (jm, jp), (tm, tp) = _models(arch)
    assert tm.param_count(tp) == jm.param_count(jp)
    assert tm.active_param_count(tp) == jm.active_param_count(jp)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if jget_arch(a).has_decode])
def test_prefill_decode_matches_forward(arch):
    """The reference's case on the port (its own weights): prefill of 12
    tokens, then 4 decode steps, within 5e-4 of the full forward."""
    cfg = get_arch(arch).reduced()
    model = get_model(cfg, moe_no_drop=True)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    b, s = 2, 16
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(1))
    full, _ = model.forward(params, {"tokens": toks})
    lp, cache = model.prefill(params, {"tokens": toks[:, :s - 4]},
                              cache_dtype=torch.float32)
    errs = [float((lp - full[:, s - 5]).abs().max())]
    if "k" in cache and cache["k"].shape[-2] < s:
        pad = s - cache["k"].shape[-2]
        cache["k"] = torch.nn.functional.pad(cache["k"], (0, 0, 0, pad))
        cache["v"] = torch.nn.functional.pad(cache["v"], (0, 0, 0, pad))
    for t in range(s - 4, s):
        lg, cache = model.decode_step(params, cache, toks[:, t])
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < DECODE_TOL, (arch, errs)


def test_train_launcher_on_a_frontend_arch():
    """A frontend arch trains on synthetic embeddings, as the JAX
    launcher feeds it."""
    from repro_torch.launch import train
    losses = train.main(["--arch", "paligemma-3b", "--reduced", "--steps",
                         "2", "--batch", "2", "--seq", "8", "--device",
                         "cpu"])
    assert len(losses) == 2 and np.isfinite(losses).all()
