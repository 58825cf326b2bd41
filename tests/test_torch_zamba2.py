"""The port's Mamba2 blocks and Zamba2 hybrid LM (CPU) against the JAX
package's ``repro.models.mamba2`` on the same converted weights and numpy
inputs: the chunked SSD scan (against the reference's and the per-token
oracle), ``apply_mamba2_seq`` / ``apply_mamba2_step`` with carried
states, the ``Zamba2LM`` param tree, ``forward``, ``prefill``,
``decode_step``, greedy tokens of the dense path and the launcher.  Its
training is held in ``tests/test_torch_train_families.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro_torch.configs.base import ArchConfig, get_arch  # noqa: E402
from repro_torch.models import mamba2 as M  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime.serve import make_serving_fns  # noqa: E402

# f32 on both sides; only summation orders differ
SSD_TOL = 1e-5
LOGIT_TOL = 1e-4
ORACLE_TOL = 1e-4        # the chunked form against the per-token recurrence


def _port_cfg(jcfg):
    return ArchConfig(**dataclasses.asdict(jcfg))


def _np(t):
    return t.detach().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _ssd_inputs(b, s, h, dh, ds, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    da = (-np.exp(rng.uniform(0.0, 2.0, h)) * dt).astype(np.float32)
    bm = rng.standard_normal((b, s, ds)).astype(np.float32)
    cm = rng.standard_normal((b, s, ds)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((b, h, dh, ds))).astype(np.float32)
    return x, dt, da, bm, cm, h0


@pytest.mark.parametrize("s,chunk", [(16, 4), (48, 16), (64, 64), (8, 64)])
def test_ssd_chunked_matches_jax_and_oracle(s, chunk):
    args = _ssd_inputs(2, s, 3, 8, 5)
    want_y, want_h = JM.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    targs = [torch.from_numpy(a) for a in args]
    y, h = M.ssd_chunked(*targs, chunk=chunk)
    _close(y, want_y, SSD_TOL)
    _close(h, want_h, SSD_TOL)
    ry, rh = M.ssd_ref(*targs)
    _close(y, _np(ry), ORACLE_TOL)
    _close(h, _np(rh), ORACLE_TOL)
    jy, jh = JM.ssd_ref(*map(jnp.asarray, args))
    _close(ry, jy, SSD_TOL)
    _close(rh, jh, SSD_TOL)


def test_ssd_chunk_matches_jax():
    """One chunk of one (batch, head) against the reference's."""
    x, dt, da, bm, cm, h0 = _ssd_inputs(1, 8, 1, 4, 3, seed=2)
    args = (x[0, :, 0], dt[0, :, 0], da[0, :, 0], h0[0, 0])
    want_y, want_h = JM.ssd_chunk((jnp.asarray(cm[0]), jnp.asarray(bm[0])),
                                  *map(jnp.asarray, args))
    y, h = M.ssd_chunk((torch.from_numpy(cm[0]), torch.from_numpy(bm[0])),
                       *map(torch.from_numpy, args))
    _close(y, want_y, SSD_TOL)
    _close(h, want_h, SSD_TOL)


def test_ssd_chunked_refuses_a_partial_chunk():
    args = [torch.from_numpy(a) for a in _ssd_inputs(1, 10, 2, 4, 3)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        M.ssd_chunked(*args, chunk=4)


def _block(seed=0):
    jcfg = jget_arch("zamba2_1_2b").reduced()
    jp = jax.device_get(JM.init_mamba2(jax.random.PRNGKey(seed), jcfg))
    jp = jax.tree.map(np.array, jp)
    rng = np.random.default_rng(seed + 1)
    # the init's zero leaves get weight, so every path carries it
    jp["conv_b"] = (0.1 * rng.standard_normal(jp["conv_b"].shape)).astype(
        np.float32)
    jp["dt_bias"] = (0.3 * rng.standard_normal(jp["dt_bias"].shape)).astype(
        np.float32)
    _, n_heads, conv_dim = JM.mamba2_dims(jcfg)
    conv = (0.5 * rng.standard_normal(
        (2, JM.D_CONV - 1, conv_dim))).astype(np.float32)
    ssm = (0.5 * rng.standard_normal(
        (2, n_heads, jcfg.ssm_head_dim, jcfg.ssm_state))).astype(np.float32)
    return jcfg, jp, conv, ssm, rng


@pytest.mark.parametrize("s,chunk", [(16, 8), (12, 64)])
def test_apply_mamba2_seq_matches_jax(s, chunk):
    jcfg, jp, conv, ssm, rng = _block()
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    want = JM.apply_mamba2_seq(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                               jcfg, jnp.asarray(conv), jnp.asarray(ssm),
                               chunk=chunk)
    got = M.apply_mamba2_seq(params_from_jax(jp, device="cpu"),
                             torch.from_numpy(x), _port_cfg(jcfg),
                             torch.from_numpy(conv), torch.from_numpy(ssm),
                             chunk=chunk)
    for g, w in zip(got, want):
        _close(g, w, SSD_TOL)


def test_apply_mamba2_step_matches_jax():
    jcfg, jp, conv, ssm, rng = _block(seed=3)
    x = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    want = JM.apply_mamba2_step(jax.tree.map(jnp.asarray, jp),
                                jnp.asarray(x), jcfg, jnp.asarray(conv),
                                jnp.asarray(ssm))
    got = M.apply_mamba2_step(params_from_jax(jp, device="cpu"),
                              torch.from_numpy(x), _port_cfg(jcfg),
                              torch.from_numpy(conv), torch.from_numpy(ssm))
    for g, w in zip(got, want):
        _close(g, w, SSD_TOL)


# -- Zamba2LM -------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jget_arch("zamba2_1_2b").reduced()
    jm = jget_model(jcfg, compute_dtype=jnp.float32)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    jp = jax.tree.map(np.array, jp)
    rng = np.random.default_rng(7)
    for name in ("conv_b", "dt_bias"):
        leaf = jp["layers"]["mamba"][name]
        jp["layers"]["mamba"][name] = (0.2 * rng.standard_normal(
            leaf.shape)).astype(np.float32)
    tm = get_model(_port_cfg(jcfg))
    tp = params_from_jax(jp, device="cpu")
    return jcfg, (jm, jax.tree.map(jnp.asarray, jp)), (tm, tp)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def test_zamba2_config_and_groups(models):
    jcfg, (jm, _), (tm, _) = models
    assert (dataclasses.asdict(get_arch("zamba2_1_2b")) ==
            dataclasses.asdict(jget_arch("zamba2_1_2b")))
    assert isinstance(tm.impl, M.Zamba2LM)
    assert tm.groups == jm.impl.groups and tm.n_attn == jm.impl.n_attn == 3
    full = get_model(get_arch("zamba2_1_2b")).impl
    assert len(full.groups) == 7 and full.groups[-1] == (36, 38)


def test_zamba2_init_has_the_jax_tree(models):
    jcfg, (_, jp), (tm, _) = models
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    got = jax.tree.map(lambda t: tuple(t.shape), tp)
    want = jax.tree.map(lambda a: tuple(a.shape), jax.device_get(jp))
    assert got == want
    a_log = tp["layers"]["mamba"]["a_log"]
    np.testing.assert_allclose(_np(a_log[-1]), np.asarray(
        jp["layers"]["mamba"]["a_log"][-1]), rtol=1e-6)
    conv_w = tp["layers"]["mamba"]["conv_w"]
    assert 0.05 < float(conv_w.std()) < 0.2          # 0.1 * N(0, 1)


@pytest.mark.parametrize("s", [16, 128])            # 128: two chunks of 64
def test_zamba2_forward_matches_jax(models, s):
    jcfg, (jm, jp), (tm, tp) = models
    toks = _tokens(jcfg, 2, s, seed=s)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    _close(got, want, LOGIT_TOL)
    assert float(aux) == 0.0


def test_zamba2_prefill_decode_match_jax(models):
    jcfg, (jm, jp), (tm, tp) = models
    toks = _tokens(jcfg, 2, 16, seed=1)
    want, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :12])},
                           cache_dtype=jnp.float32)
    got, tst = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :12])},
                          cache_dtype=torch.float32)
    _close(got, want, LOGIT_TOL)
    assert tst["index"] == int(jst["index"]) == 12
    for name in ("k", "v", "conv", "ssm"):
        assert tuple(tst[name].shape) == tuple(jst[name].shape), name
        _close(tst[name], jst[name], LOGIT_TOL)
    pad = [(0, 0)] * 3 + [(0, 4), (0, 0)]
    jst = {**jst, "k": jnp.pad(jst["k"], pad), "v": jnp.pad(jst["v"], pad)}
    tst = {**tst, "k": torch.nn.functional.pad(tst["k"], (0, 0, 0, 4)),
           "v": torch.nn.functional.pad(tst["v"], (0, 0, 0, 4))}
    for t in range(12, 16):
        want, jst = jm.decode_step(jp, jst, jnp.asarray(toks[:, t]))
        got, tst = tm.decode_step(tp, tst, torch.from_numpy(toks[:, t]))
        _close(got, want, LOGIT_TOL)
        _close(tst["ssm"], jst["ssm"], LOGIT_TOL)
    assert tst["index"] == 16


def test_zamba2_cache_spec_and_init_cache(models):
    jcfg, (jm, _), (tm, _) = models
    want = jax.tree.map(lambda s: (s.shape, s.dtype), jm.cache_spec(2, 32))
    got = tm.cache_spec(2, 32)
    assert {n: tuple(sh) for n, (sh, _) in got.items()} == {
        n: tuple(v[0]) for n, v in want.items() if n != "index"}
    cache = tm.init_cache(2, 32, device="cpu")
    assert cache["index"] == 0 and cache["ssm"].dtype == torch.float32
    # O(1) decode state: only the shared block's K/V grow with the length
    long = tm.cache_spec(2, 4096)
    assert long["conv"] == got["conv"] and long["ssm"] == got["ssm"]


def test_zamba2_dense_greedy_tokens_match_jax(models):
    jcfg, (jm, jp), (tm, tp) = models
    prompts = _tokens(jcfg, 3, 8, seed=6)
    gen = 6
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)},
                               cache_dtype=jnp.float32)
    widths = [(0, 0)] * 3 + [(0, gen), (0, 0)]
    cache = {**cache, "k": jnp.pad(cache["k"], widths),
             "v": jnp.pad(cache["v"], widths)}
    want, cur = [], jnp.argmax(logits, -1).astype(jnp.int32)
    for _ in range(gen):
        want.append(np.asarray(cur))
        logits, cache = jm.decode_step(jp, cache, cur)
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
    prefill, decode = make_serving_fns(tm)
    logits, tc = prefill(tp, {"tokens": torch.from_numpy(prompts)},
                         cache_dtype=torch.float32)
    tc["k"] = torch.nn.functional.pad(tc["k"], (0, 0, 0, gen))
    tc["v"] = torch.nn.functional.pad(tc["v"], (0, 0, 0, gen))
    got, cur = [], logits.argmax(-1)
    for _ in range(gen):
        got.append(cur.numpy())
        logits, tc = decode(tp, tc, cur)
        cur = logits.argmax(-1)
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))


def test_zamba2_forward_goes_through_the_flash_wrapper(models, monkeypatch):
    """The shared block's prefill attention runs
    ``layers.chunked_attention`` (the flash kernel's wrapper), once per
    application of the block."""
    from repro_torch.kernels import ops
    jcfg, _, (tm, tp) = models
    calls = []
    real = ops.flash_attention

    def counted(*a, **kw):
        calls.append(kw.get("causal"))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counted)
    tm.forward(tp, {"tokens": torch.from_numpy(_tokens(jcfg, 1, 8))})
    assert calls == [True] * tm.n_attn


def test_zamba2_launcher_default_path_on_cpu():
    from repro_torch.launch import serve
    out = serve.main(["--arch", "zamba2-1.2b", "--reduced", "--requests",
                      "2", "--prompt-len", "8", "--gen", "4", "--device",
                      "cpu"])
    vocab = get_arch("zamba2_1_2b").reduced().vocab_size
    assert {k: len(v) for k, v in out.items()} == {0: 4, 1: 4}
    assert all(0 <= t < vocab for v in out.values() for t in v)
