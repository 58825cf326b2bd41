"""The port's dense serving slice (CPU) against the JAX package on the
same converted weights and numpy inputs: chunked and decode attention,
TransformerLM and RWKV6LM prefill / decode_step / forward, greedy tokens
of the dense path, the dense path against the port's own PagedServer,
and the launcher's default path."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro_torch.configs.base import ArchConfig, get_arch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import (TransformerLM,  # noqa: E402
                                            causal_attention)
from repro_torch.runtime.serve import (PagedServer,  # noqa: E402
                                       make_serving_fns)

# f32 on both sides; only summation orders differ
ATTN_TOL = 1e-5
LOGIT_TOL = 1e-4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _port_cfg(jcfg):
    return ArchConfig(**dataclasses.asdict(jcfg))


def _models(arch, noise=False, **over):
    """(cfg, (jax model, jax params), (port model, port params)): two
    layers, f32 compute.  ``noise`` adds seeded numpy noise to the JAX
    init's zero leaves of RWKV6 (token-shift mixes, LoRA and decay
    up-projections), so the data-dependent paths carry weight."""
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), n_layers=2, **over)
    jmodel = jget_model(jcfg, compute_dtype=jnp.float32, moe_no_drop=True)
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    if noise:
        rng = np.random.default_rng(7)
        for blk in ("time_mix", "channel_mix"):
            for name, leaf in jparams["layers"][blk].items():
                if name.startswith("mu_") or name in ("lora_b", "wb"):
                    jparams["layers"][blk][name] = (rng.standard_normal(
                        leaf.shape) * 0.3).astype(np.float32)
    tparams = params_from_jax(jparams, device="cpu")
    jparams = jax.tree.map(jnp.asarray, jparams)
    return jcfg, (jmodel, jparams), (get_model(_port_cfg(jcfg)), tparams)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# Rounding the same f32 value from both sides to bf16 can land on two
# neighbouring bf16 values when the two f32 values (equal to ~1e-7)
# straddle a rounding boundary (seen: 1 of 1792 prefill cache elements,
# and 1 of 512 new decode rows a step), and one such element moves the
# logits by up to ~6e-4.  So a bf16 cache is compared within one bf16
# step, decode starts on both sides from the JAX package's cache
# (converted exactly), and decode logits over a bf16 cache are held
# within 1e-3; over an f32 cache, within 1e-4.
BF16_STEP = 2.0 ** -7
BF16_LOGIT_TOL = 1e-3


def _cache_to_port(jcache, like):
    return {n: (int(a) if n == "index" else
                torch.from_numpy(np.array(a, np.float32)).to(like[n].dtype))
            for n, a in jcache.items()}


# -- attention ---------------------------------------------------------------


@pytest.mark.parametrize("h,hkv,s", [(4, 2, 7), (4, 4, 11), (8, 1, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax(h, hkv, s, causal):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, s, h, 16), dtype=np.float32)
    k = rng.standard_normal((2, s, hkv, 16), dtype=np.float32)
    v = rng.standard_normal((2, s, hkv, 16), dtype=np.float32)
    want = JL.chunked_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = L.chunked_attention(tq, tk, tv, causal=causal)
    _close(got, want, ATTN_TOL)
    if causal:
        pos = torch.arange(s)[None].expand(2, s)
        _close(causal_attention(tq, tk, tv, pos), want, ATTN_TOL)


@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_decode_attention_matches_jax(cache):
    cfg, (_, jparams), (_, tparams) = _models("granite_3_2b")
    jdt, tdt = DTYPES[cache]
    rng = np.random.default_rng(1)
    b, s, index = 2, 9, 5
    x = rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32)
    kc = rng.standard_normal((b, cfg.n_kv_heads, s, cfg.hd),
                             dtype=np.float32)
    vc = rng.standard_normal(kc.shape, dtype=np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    want, wk, wv = JL.decode_attention(jp, jnp.asarray(x), cfg,
                                       jnp.asarray(kc, jdt),
                                       jnp.asarray(vc, jdt), jnp.int32(index))
    tp = {n: t[0] for n, t in tparams["layers"]["attn"].items()}
    got, gk, gv = L.decode_attention(
        tp, torch.from_numpy(x), _port_cfg(cfg),
        torch.from_numpy(kc).to(tdt), torch.from_numpy(vc).to(tdt), index)
    _close(got, want, ATTN_TOL)
    _close(gk, np.asarray(wk, np.float32), ATTN_TOL)
    _close(gv, np.asarray(wv, np.float32), ATTN_TOL)


# -- TransformerLM -------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen2_72b"])  # qkv bias
@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_transformer_prefill_decode_match_jax(arch, cache):
    cfg, (jm, jp), (tm, tp) = _models(arch, vocab_size=64)
    jdt, tdt = DTYPES[cache]
    prompts = _tokens(cfg, 2, 7)
    want, jcache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)},
                              cache_dtype=jdt)
    got, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)},
                             cache_dtype=tdt)
    _close(got, want)
    assert tcache["k"].dtype == tdt and tcache["index"] == 7
    for name in ("k", "v"):
        _close(tcache[name], jcache[name],
               LOGIT_TOL if cache == "f32" else BF16_STEP)
    widths = [(0, 0)] * 3 + [(0, 3), (0, 0)]
    jcache = {**jcache, "k": jnp.pad(jcache["k"], widths),
              "v": jnp.pad(jcache["v"], widths)}
    tcache = _cache_to_port(jcache, tcache)
    cur = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    for _ in range(3):
        want, jcache = jm.decode_step(jp, jcache, jnp.asarray(cur))
        got, tcache = tm.decode_step(tp, tcache, torch.from_numpy(cur).long())
        _close(got, want, LOGIT_TOL if cache == "f32" else BF16_LOGIT_TOL)
        cur = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    assert tcache["index"] == int(jcache["index"]) == 10


def test_transformer_forward_goes_through_chunked_attention():
    cfg, (jm, jp), (tm, tp) = _models("granite_3_2b", vocab_size=64)
    tokens = _tokens(cfg, 2, 11, seed=3)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(tokens).long()})
    _close(got, want)


# -- RWKV6LM ---------------------------------------------------------------------


def test_rwkv6_config_matches_the_jax_registry():
    assert (dataclasses.asdict(get_arch("rwkv6_3b")) ==
            dataclasses.asdict(jget_arch("rwkv6_3b")))


def test_rwkv6_init_has_the_jax_layout():
    cfg, (_, jp), _ = _models("rwkv6_3b")
    tp = get_model(_port_cfg(cfg)).init(torch.Generator().manual_seed(0),
                                        device="cpu")
    got = jax.tree.map(lambda t: tuple(t.shape), tp)
    want = jax.tree.map(lambda a: tuple(a.shape), jax.device_get(jp))
    assert got == want
    assert float(tp["layers"]["time_mix"]["w0"][0, 0]) == np.float32(-0.6)


@pytest.mark.parametrize("s", [7, 11, 64])   # 64 = two chunks of 32
def test_rwkv6_forward_matches_jax(s):
    cfg, (jm, jp), (tm, tp) = _models("rwkv6_3b", noise=True)
    tokens = _tokens(cfg, 2, s, seed=4)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(tokens).long()})
    _close(got, want)


@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_rwkv6_prefill_decode_match_jax(cache):
    cfg, (jm, jp), (tm, tp) = _models("rwkv6_3b", noise=True)
    jdt, tdt = DTYPES[cache]
    prompts = _tokens(cfg, 2, 16, seed=5)
    want, jst = jm.prefill(jp, {"tokens": jnp.asarray(prompts)},
                           cache_dtype=jdt)
    got, tst = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)},
                          cache_dtype=tdt)
    _close(got, want)
    assert tst["shift_tm"].dtype == tdt and tst["index"] == 16
    for name in ("shift_tm", "shift_cm", "wkv"):
        _close(tst[name], jst[name], LOGIT_TOL if cache == "f32" or
               name == "wkv" else BF16_STEP)
    tst = _cache_to_port(jst, tst)
    cur = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    for _ in range(3):
        want, jst = jm.decode_step(jp, jst, jnp.asarray(cur))
        got, tst = tm.decode_step(tp, tst, torch.from_numpy(cur).long())
        _close(got, want)
        _close(tst["wkv"], jst["wkv"])
        cur = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    assert tst["index"] == int(jst["index"]) == 19


# -- the dense serving path ------------------------------------------------------


def _jax_dense_tokens(model, params, prompts, gen, cache_dtype=jnp.float32):
    """The JAX package's dense path (``tests/test_serve.py``'s
    reference): prefill, pad, argmax decode.  Returns (tokens [B, gen],
    the logits that chose them [gen, B, V])."""
    logits, cache = model.prefill(params, {"tokens": jnp.asarray(prompts)},
                                  cache_dtype=cache_dtype)
    if "k" in cache:
        widths = [(0, 0)] * 3 + [(0, gen), (0, 0)]
        cache["k"] = jnp.pad(cache["k"], widths)
        cache["v"] = jnp.pad(cache["v"], widths)
    outs, seen = [], []
    cur = jnp.argmax(logits, -1).astype(jnp.int32)
    for _ in range(gen):
        outs.append(np.asarray(cur))
        seen.append(np.asarray(logits))
        logits, cache = model.decode_step(params, cache, cur)
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
    return np.stack(outs, axis=1), np.stack(seen)


def _port_dense_tokens(model, params, prompts, gen,
                       cache_dtype=torch.float32):
    prefill, decode = make_serving_fns(model)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(prompts)},
                            cache_dtype=cache_dtype)
    if "k" in cache:
        cache["k"] = torch.nn.functional.pad(cache["k"], (0, 0, 0, gen))
        cache["v"] = torch.nn.functional.pad(cache["v"], (0, 0, 0, gen))
    outs, seen = [], []
    cur = logits.argmax(-1)
    for _ in range(gen):
        outs.append(cur.numpy())
        seen.append(logits.numpy())
        logits, cache = decode(params, cache, cur)
        cur = logits.argmax(-1)
    return np.stack(outs, axis=1), np.stack(seen)


@pytest.mark.parametrize("arch,noise", [("granite_3_2b", False),
                                        ("rwkv6_3b", True)])
@pytest.mark.parametrize("cache", ["f32", "bf16"])  # bf16: launcher default
def test_dense_greedy_tokens_match_jax(arch, noise, cache):
    """Each side decodes from its own prefill: tokens identical, every
    step's logits within the cache's tolerance."""
    cfg, (jm, jp), (tm, tp) = _models(arch, noise=noise, vocab_size=64)
    jdt, tdt = DTYPES[cache]
    prompts = _tokens(cfg, 3, 8, seed=6)
    want, want_logits = _jax_dense_tokens(jm, jp, prompts, 6, jdt)
    got, got_logits = _port_dense_tokens(tm, tp, prompts, 6, tdt)
    np.testing.assert_array_equal(got, want)
    tol = LOGIT_TOL if cache == "f32" else BF16_LOGIT_TOL
    np.testing.assert_allclose(got_logits, want_logits, atol=tol, rtol=tol)


def test_dense_tokens_equal_the_paged_servers():
    cfg, _, (tm, tp) = _models("granite_3_2b", vocab_size=64)
    prompts = _tokens(cfg, 3, 9, seed=8)
    dense, _ = _port_dense_tokens(tm, tp, prompts, 6)
    server = PagedServer(tm, tp, page_size=4, hbm_pages=32, device="cpu")
    first = [int(server.add_request(i, p).argmax()) for i, p in
             enumerate(prompts)]
    rest = server.decode(5)
    paged = np.asarray([[first[i]] + rest[i] for i in range(3)])
    np.testing.assert_array_equal(dense, paged)


def test_make_serving_fns_over_a_mesh_is_not_ported():
    model = get_model(get_arch("granite_3_2b").reduced())
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make_serving_fns(model, mesh=object())


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-3b"])
def test_launcher_default_path_on_cpu(arch):
    from repro_torch.launch import serve
    out = serve.main(["--arch", arch, "--reduced", "--requests", "2",
                      "--prompt-len", "6", "--gen", "4", "--device", "cpu"])
    vocab = get_arch(arch).reduced().vocab_size
    assert sorted(out) == [0, 1]
    assert all(len(t) == 4 and all(0 <= x < vocab for x in t)
               for t in out.values())
