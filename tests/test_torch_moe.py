"""The port's MoE FFN and int8 dense-decode cache (CPU) against the JAX
package on the same converted weights and numpy inputs: ``quantize_kv``
and ``decode_attention_q8``, the reference's two int8 cases on the port,
``apply_moe`` (routed rows) and its dense-dispatch plain version at top-2
and top-1, dropping and not, with tied router probabilities; the MoE
``TransformerLM`` forward / prefill / decode / loss and its gradients;
MoE ``PagedServer`` and ``PoolServer`` serving; the launcher's dense,
paged and pool paths on MoE archs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.runtime.serve import PagedServer as JServer  # noqa: E402
from repro_torch.configs.base import ArchConfig, get_arch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime.pool import PoolServer  # noqa: E402
from repro_torch.runtime.serve import PagedServer  # noqa: E402

# f32 on both sides; only summation orders differ
OUT_TOL = 1e-5
AUX_TOL = 1e-6
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4          # times max(1, max |g_ref|)
MOE_ARCHS = ("phi3_5_moe_42b_a6_6b", "llama4_scout_17b_a16e")


def _port_cfg(jcfg):
    return ArchConfig(**dataclasses.asdict(jcfg))


def _np(t):
    return t.detach().numpy()


# -- int8 dense decode --------------------------------------------------------


@pytest.mark.parametrize("shape,zero_rows", [((4, 2, 8, 64), False),
                                             ((2, 4, 16), True),
                                             ((3, 1, 5, 16), False)])
def test_quantize_kv_bit_for_bit(shape, zero_rows):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    x *= np.random.default_rng(1).uniform(0.01, 30.0, shape[:-1] + (1,))
    if zero_rows:
        x[0] = 0.0
    jq, js = JL.quantize_kv(jnp.asarray(x))
    tq, ts = L.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))


def _q8_layer(arch, b=2, s=12, index=7, seed=0):
    jcfg = jget_arch(arch).reduced()
    jp = jax.device_get(JL.init_attention(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, b, jcfg.n_kv_heads, s, jcfg.hd)).astype(
        np.float32)
    codes, scales = (np.asarray(a) for a in JL.quantize_kv(jnp.asarray(kv)))
    return jcfg, jp, x, codes, scales, index


@pytest.mark.parametrize("arch", ["qwen2_72b", "phi3_5_moe_42b_a6_6b"])
def test_decode_attention_q8_matches_jax(arch):
    jcfg, jp, x, codes, scales, index = _q8_layer(arch)
    want = JL.decode_attention_q8(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg,
        *(jnp.asarray(a) for a in (codes[0], codes[1], scales[0],
                                   scales[1])), index)
    caches = [torch.from_numpy(a.copy()) for a in (codes[0], codes[1],
                                                   scales[0], scales[1])]
    got = L.decode_attention_q8(params_from_jax(jp, device="cpu"),
                                torch.from_numpy(x), _port_cfg(jcfg),
                                *caches, index)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]),
                               atol=OUT_TOL, rtol=OUT_TOL)
    # written in place at ``index``; elsewhere untouched
    for g, w, c in zip(got[1:], want[1:], caches):
        assert g is c
        np.testing.assert_allclose(_np(g).astype(np.float32),
                                   np.asarray(w).astype(np.float32),
                                   atol=1.0 if g.dtype == torch.int8 else
                                   1e-6, rtol=1e-6)
    np.testing.assert_array_equal(_np(caches[0])[:, :, :index],
                                  codes[0][:, :, :index])


def test_int8_kv_decode_matches_fp():
    """``tests/test_optimizations.py``'s case on the port: the prefill
    cache quantized, 8 decode steps; softmax within 5e-3 of the f32
    cache's, greedy tokens equal wherever f32 clearly prefers one."""
    cfg = get_arch("qwen2_72b").reduced()
    m_fp = get_model(cfg)
    m_q8 = get_model(cfg, kv_quant="int8")
    p = m_fp.init(torch.Generator().manual_seed(0), device="cpu")
    b, s = 2, 24
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(1))
    _, cache_fp = m_fp.prefill(p, {"tokens": toks[:, :16]},
                               cache_dtype=torch.float32)
    for name in ("k", "v"):
        cache_fp[name] = torch.nn.functional.pad(cache_fp[name],
                                                 (0, 0, 0, s - 16))
    kq, ks = L.quantize_kv(cache_fp["k"])
    vq, vs = L.quantize_kv(cache_fp["v"])
    cache_q8 = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs,
                "index": cache_fp["index"]}
    assert {n: (tuple(sh), dt) for n, (sh, dt) in
            m_q8.cache_spec(b, s).items()} == {
        n: (tuple(t.shape), t.dtype) for n, t in cache_q8.items()
        if n != "index"}
    for t in range(16, s):
        lf, cache_fp = m_fp.decode_step(p, cache_fp, toks[:, t])
        lq, cache_q8 = m_q8.decode_step(p, cache_q8, toks[:, t])
        pf, pq = torch.softmax(lf, -1), torch.softmax(lq, -1)
        assert float((pf - pq).abs().max()) < 5e-3
        top2 = torch.sort(lf, dim=-1).values[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0] > 0.05).numpy()
        np.testing.assert_array_equal(lf.argmax(-1).numpy()[decisive],
                                      lq.argmax(-1).numpy()[decisive])
    assert cache_q8["index"] == s


def test_quantize_kv_roundtrip_bound():
    x = torch.randn((4, 2, 8, 64), generator=torch.Generator().manual_seed(0))
    q, s = L.quantize_kv(x)
    deq = q.float() * s[..., None]
    # error bounded by half an LSB of the per-token scale
    assert float((deq - x).abs().max()) <= float(s.max()) * 0.51
    assert q.dtype == torch.int8


def test_int8_decode_step_matches_jax():
    """The int8 cache's decode step on the port against the reference's
    on the same weights and the same int8 cache: logits within 1e-4."""
    jcfg = dataclasses.replace(jget_arch("qwen2_72b").reduced(), n_layers=2)
    jm = jget_model(jcfg, compute_dtype=jnp.float32, kv_quant="int8")
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(_port_cfg(jcfg), kv_quant="int8")
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 14),
                                             dtype=np.int32)
    _, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :10])},
                          cache_dtype=jnp.float32)
    kv = {n: np.pad(np.asarray(cache[n]), [(0, 0)] * 3 + [(0, 4), (0, 0)])
          for n in ("k", "v")}
    jc = {"index": cache["index"]}
    for n in ("k", "v"):
        q, s = JL.quantize_kv(jnp.asarray(kv[n]))
        jc[n], jc[f"{n}_scale"] = q, s
    tc = {n: torch.from_numpy(np.asarray(a).copy()) for n, a in jc.items()
          if n != "index"}
    tc["index"] = 10
    for t in range(10, 14):
        want, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t]))
        got, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t]).long())
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


# -- the MoE FFN --------------------------------------------------------------


def _moe(arch, seed=0, tie=None, b=2, s=16):
    jcfg = jget_arch(arch).reduced()
    jp = jax.device_get(JL.init_moe(jax.random.PRNGKey(seed), jcfg))
    jp = {k: np.array(v) for k, v in jp.items()}
    if tie == "zero":                      # every probability 1 / E
        jp["router"][:] = 0.0
    elif tie == "columns":                 # experts 1 and 2 always tied
        jp["router"][:, 2] = jp["router"][:, 1]
    x = np.random.default_rng(seed + 1).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    return jcfg, jp, x


def _jax_keep(jp, x, cfg, capacity):
    """The reference's kept (token, slot) pairs, from its own formulas."""
    xt = jnp.asarray(x).reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(xt @ jnp.asarray(jp["router"]), axis=-1)
    _, topi = jax.lax.top_k(probs, cfg.top_k)
    keep = []
    for j in range(cfg.top_k):
        onehot = jax.nn.one_hot(topi[:, j], cfg.n_experts, dtype=jnp.int32)
        pos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1
        keep.append(np.asarray(pos < capacity))
    return np.asarray(topi), np.stack(keep, axis=1)


@pytest.mark.parametrize("tie", [None, "zero", "columns"])
@pytest.mark.parametrize("capacity,no_drop", [(None, True), (None, False),
                                              (3, False)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_jax(arch, capacity, no_drop, tie):
    jcfg, jp, x = _moe(arch, tie=tie)
    cfg = _port_cfg(jcfg)
    want, jaux = JL.apply_moe(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                              jcfg, capacity=capacity, no_drop=no_drop)
    tp = params_from_jax(jp, device="cpu")
    tx = torch.from_numpy(x)
    got, aux = L.apply_moe(tp, tx, cfg, capacity=capacity, no_drop=no_drop)
    plain, plain_aux = L.apply_moe_dense(tp, tx, cfg, capacity=capacity,
                                         no_drop=no_drop)
    for out in (got, plain):
        np.testing.assert_allclose(_np(out), np.asarray(want), atol=OUT_TOL,
                                   rtol=OUT_TOL)
    for a in (aux, plain_aux):
        np.testing.assert_allclose(float(a), float(jaux), atol=AUX_TOL,
                                   rtol=AUX_TOL)
    t = x.shape[0] * x.shape[1]
    cap = L.moe_capacity(cfg, t, capacity, no_drop)
    _, topi, keep, _ = L.moe_route(tp, tx.reshape(t, -1), cfg, cap)
    want_topi, want_keep = _jax_keep(jp, x, jcfg, cap)
    np.testing.assert_array_equal(_np(topi), want_topi)
    np.testing.assert_array_equal(_np(keep), want_keep)
    if capacity == 3:
        assert not want_keep.all()          # the case drops tokens
    if tie == "zero":                       # ties to the lower expert id
        assert (want_topi == np.arange(cfg.top_k)).all()


def test_apply_moe_runs_experts_on_kept_rows_only():
    """Each expert's products see only the rows routed to it (and kept):
    the matmuls' row counts sum to the kept (token, slot) pairs."""
    jcfg, jp, x = _moe("phi3_5_moe_42b_a6_6b")
    cfg = _port_cfg(jcfg)
    tp = params_from_jax(jp, device="cpu")
    rows = []

    class Rows(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in ("__matmul__", "matmul") \
                    and args[1].shape == (cfg.d_model, cfg.d_ff):
                rows.append(args[0].shape[0])
            return func(*args, **(kwargs or {}))

    tx = torch.from_numpy(x)
    with Rows():
        L.apply_moe(tp, tx, cfg, capacity=3)
    _, _, keep, _ = L.moe_route(tp, tx.reshape(-1, cfg.d_model), cfg, 3)
    # w_gate and w_up each once an expert with rows
    assert sum(rows) == 2 * int(keep.sum()) < 2 * keep.numel()


# -- the MoE TransformerLM ------------------------------------------------------


def _models(arch, moe_no_drop, n_layers=2):
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), n_layers=n_layers)
    jm = jget_model(jcfg, compute_dtype=jnp.float32, moe_no_drop=moe_no_drop)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm = get_model(_port_cfg(jcfg), moe_no_drop=moe_no_drop)
    return jcfg, (jm, jax.tree.map(jnp.asarray, jp)), (
        tm, params_from_jax(jp, device="cpu"))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


@pytest.mark.parametrize("moe_no_drop", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_prefill_decode_match_jax(arch, moe_no_drop):
    jcfg, (jm, jp), (tm, tp) = _models(arch, moe_no_drop)
    toks = _tokens(jcfg, 2, 16)
    want, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=AUX_TOL,
                               rtol=AUX_TOL)
    assert float(aux) > 0
    want, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :12])},
                          cache_dtype=jnp.float32)
    got, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :12]).long()},
                         cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    pad = [(0, 0)] * 3 + [(0, 4), (0, 0)]
    jc = {**jc, "k": jnp.pad(jc["k"], pad), "v": jnp.pad(jc["v"], pad)}
    tc = {**tc, "k": torch.from_numpy(np.asarray(jc["k"]).copy()),
          "v": torch.from_numpy(np.asarray(jc["v"]).copy())}
    for t in range(12, 16):
        want, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t]))
        got, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t]).long())
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_grads_match_jax(arch):
    """The loss with its aux term, and its gradients, against
    ``jax.grad`` of the reference's (capacity drops on: the default)."""
    jcfg, (jm, jp), (tm, tp) = _models(arch, moe_no_drop=False)
    toks = _tokens(jcfg, 2, 16, seed=3)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (want, jparts), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    for _, leaf in _leaves(tp):
        leaf.requires_grad_(True)
    loss, parts = tm.loss(tp, {"tokens": torch.from_numpy(toks).long(),
                               "labels": torch.from_numpy(labels).long()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(parts["aux"].detach()),
                               float(jparts["aux"]), atol=AUX_TOL,
                               rtol=AUX_TOL)
    jg = dict(_leaves(jax.device_get(jg)))
    for path, leaf in _leaves(tp):
        g_ref = np.asarray(jg[path])
        tol = GRAD_TOL * max(1.0, float(np.abs(g_ref).max()))
        np.testing.assert_allclose(_np(leaf.grad), g_ref, atol=tol, rtol=0,
                                   err_msg=str(path))


def test_moe_model_facade():
    """``get_model`` builds the MoE arch, drops ``moe_impl`` as the
    reference's ``_filter_kwargs`` would, and counts active params as the
    reference's ``active_param_count`` does."""
    jcfg = jget_arch("phi3_5_moe_42b_a6_6b").reduced()
    jm = jget_model(jcfg, compute_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(_port_cfg(jcfg), moe_impl="shardmap", moe_no_drop=True)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    assert tm.moe_no_drop and not hasattr(tm.impl, "moe_impl")
    assert tm.param_count(tp) == jm.param_count(jp)
    assert tm.active_param_count(tp) == jm.active_param_count(jp) < \
        tm.param_count(tp)


# -- MoE serving ----------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    jcfg, (jm, jp), (tm, tp) = _models("phi3_5_moe_42b_a6_6b", True)
    prompts = _tokens(jcfg, 3, 7, seed=4)
    return jcfg, (jm, jp), (tm, tp), prompts


@pytest.mark.parametrize("page_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("horizon", [None, 8])
def test_moe_paged_server_matches_jax(served, horizon, page_dtype):
    jcfg, (jm, jp), (tm, tp), prompts = served
    kw = dict(page_size=4, hbm_pages=32, page_dtype=page_dtype)
    js = JServer(jm, jp, dtype=jnp.float32, **kw)
    ts = PagedServer(tm, tp, device="cpu", **kw)
    for i, p in enumerate(prompts):
        want = np.asarray(js.add_request(i, p, chunk=4))
        got = ts.add_request(i, p, chunk=4)
        np.testing.assert_allclose(_np(got), want, atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    assert ts.decode(6, horizon=horizon) == js.decode(6, horizon=horizon)
    assert ts.tier_stats() == js.tier_stats()


@pytest.mark.parametrize("page_dtype", ["fp32", "int8"])
def test_moe_one_node_pool_is_paged_server(served, page_dtype):
    _, _, (tm, tp), prompts = served
    ref = PagedServer(tm, tp, page_size=4, hbm_pages=32, device="cpu",
                      page_dtype=page_dtype)
    srv = PoolServer(tm, tp, n_nodes=1, page_size=4, hbm_pages_per_node=32,
                     device="cpu", page_dtype=page_dtype)
    for i, p in enumerate(prompts):
        assert torch.equal(ref.add_request(i, p, chunk=4),
                           srv.add_request(i, p, chunk=4))
    for _ in range(3):
        toks = ref.pending_tokens()
        a, b = ref.step(toks), srv.step(toks)
        assert all(torch.equal(a[s], b[s]) for s in a)
        for s, lg in a.items():
            ref.set_pending(s, int(lg.argmax()))
            srv.set_pending(s, int(lg.argmax()))
    assert ref.decode(6, horizon=8) == srv.decode(6, horizon=8)


@pytest.mark.parametrize("arch,flags", [
    ("phi3.5-moe-42b-a6.6b", []),
    ("llama4-scout-17b-a16e", []),
    ("llama4-scout-17b-a16e", ["--paged", "--horizon", "4"]),
    ("llama4-scout-17b-a16e", ["--pool", "--nodes", "2"])])
def test_moe_launcher_paths_on_cpu(arch, flags):
    """Every launcher path the JAX launcher gives an MoE arch: the dense
    default, ``--paged`` and ``--pool``."""
    from repro_torch.launch import serve
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "6", "--gen", "3",
                      "--page-size", "4", "--hbm-pages", "16", *flags])
    vocab = get_arch(arch).reduced().vocab_size
    assert {k: len(v) for k, v in out.items()} == {0: 3, 1: 3}
    assert all(0 <= t < vocab for v in out.values() for t in v)
