"""The port's training kernels on the card (flash attention and the wkv
scan, forward with its saved values and backward), bf16 pages in the
paged forms, and the pool's rank route (each node's window through the
one-node pool form, ranks sharing the card over gloo): run there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

Imports torch only (the machine with the card has no JAX); every test
is marked ``cuda`` and skips without a card."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs these "
                    "kernels on one)")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


def _inputs(shape, seed):
    b, h, hkv, sq, sk, d = shape
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s, dtype=np.float32)).cuda()
    return mk(b, h, sq, d), mk(b, hkv, sk, d), mk(b, hkv, sk, d), \
        mk(b, h, sq, d)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((2, 8, 2, 77, 77, 64), True),
                                          ((1, 16, 2, 100, 100, 128), True),
                                          ((1, 4, 4, 40, 56, 160), False)],
                         ids=["mma-causal", "mma-d128-group8", "fma-full"])
def test_flash_training_kernels_on_the_card(card, shape, causal):
    """The forward with lse bit-equal in ``out`` to the forward-only
    kernel and its lse within 1e-5; the backward (the 3xTF32 route at
    D=64 and at D=128 with a group of 8, the FMA route at D=160) within
    1e-4 x max(1, max |plain|) of the plain version and deterministic;
    one launch a call."""
    q, k, v, do = _inputs(shape, seed=4)
    before = dict(FA.LAUNCHES)
    out, lse = FA.flash_attention_lse(q, k, v, causal=causal)
    assert torch.equal(out, FA.flash_attention(q, k, v, causal=causal))
    _, plain_lse = ref.flash_attention_lse_ref(q, k, v, causal)
    assert float((lse - plain_lse).abs().max()) <= 1e-5
    got = FA.flash_attention_bwd(q, k, v, out, lse, do, causal)
    again = FA.flash_attention_bwd(q, k, v, out, lse, do, causal)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        lim = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= lim
    assert FA.LAUNCHES["flash_attention_fwd_lse_f32"] == \
        before["flash_attention_fwd_lse_f32"] + 1
    assert FA.LAUNCHES["flash_attention_bwd_f32"] == \
        before["flash_attention_bwd_f32"] + 2


@pytest.mark.cuda
def test_flash_fn_trains_through_the_kernels(card):
    """``FlashAttentionFn`` on card tensors launches the kernels (no plain
    fallback) and its gradients match the plain forward's autograd."""
    q, k, v, do = _inputs((2, 4, 2, 64, 64, 32), seed=5)
    before = dict(FA.LAUNCHES)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(FA.flash_attention_with_grad(*leaves, True),
                              leaves, do)
    assert FA.LAUNCHES["flash_attention_bwd_f32"] == \
        before["flash_attention_bwd_f32"] + 1
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*leaves, True),
                               leaves, do)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * max(
            1.0, float(w.abs().max()))


# one rank's heads in the mesh_families phase: phi3.5-moe's 32 over 8 kv
# heads of 128 split over model 4 (8 over 2, G = 4) and 2 (16 over 4),
# zamba2's shared block's 32 of 64 over model 4 (8 over 8)
RANK_FLASH = {"phi3.5-moe (1, 4)": (2, 8, 2, 256, 256, 128),
              "phi3.5-moe (2, 2)": (2, 16, 4, 256, 256, 128),
              "zamba2 (1, 4)": (2, 8, 8, 256, 256, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RANK_FLASH))
def test_flash_kernels_at_a_ranks_heads(card, name):
    """The forward, the forward with lse and the backward at one rank's
    head counts, causal: each within its bound of the plain version
    (1e-4 on the output, 1e-5 on lse, 1e-4 x max(1, max |plain|) on the
    gradients), one launch a call."""
    q, k, v, do = _inputs(RANK_FLASH[name], seed=8)
    before = dict(FA.LAUNCHES)
    out = FA.flash_attention(q, k, v, causal=True)
    assert float((out - ref.flash_attention_ref(q, k, v, True)).abs()
                 .max()) <= 1e-4
    out, lse = FA.flash_attention_lse(q, k, v, causal=True)
    _, plain_lse = ref.flash_attention_lse_ref(q, k, v, True)
    assert float((lse - plain_lse).abs().max()) <= 1e-5
    got = FA.flash_attention_bwd(q, k, v, out, lse, do, True)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * max(
            1.0, float(w.abs().max()))
    for kname in ("flash_attention_f32", "flash_attention_fwd_lse_f32",
                  "flash_attention_bwd_f32"):
        assert FA.LAUNCHES[kname] == before[kname] + 1


def _wkv_inputs(b, s, h, dk, dv, seed, sigma=1.0):
    """(r, k, v, logw, u, s0, do, dsT) on the card, f32, logw =
    -exp(N(0, sigma))."""
    rng = np.random.default_rng(seed)
    mk = lambda x: torch.from_numpy(x.astype(np.float32)).cuda()
    r, k = (mk(rng.standard_normal((b, s, h, dk))) for _ in range(2))
    v = mk(rng.standard_normal((b, s, h, dv)))
    logw = mk(-np.exp(sigma * rng.standard_normal((b, s, h, dk))))
    u = mk(rng.standard_normal((h, dk)))
    s0 = mk(rng.standard_normal((b, h, dk, dv)))
    do = mk(rng.standard_normal((b, s, h, dv)))
    dsT = mk(rng.standard_normal((b, h, dk, dv)))
    return r, k, v, logw, u, s0, do, dsT


def _close(got, want, tol=1e-4):
    """max |got - want| within tol x max(1, max |want|)."""
    return float((got - want).abs().max()) <= tol * max(
        1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_wkv_states_kernel_on_the_card(card):
    """``rwkv_scan_states_f32``: o and sT bit-equal to ``rwkv_scan_f32``,
    the step states within 1e-4 x max(1, max |plain|) of
    ``ref.wkv_states_ref``; one launch a call."""
    from repro_torch.kernels import rwkv_scan as W
    r, k, v, logw, u, s0, _, _ = _wkv_inputs(2, 128, 4, 64, 64, seed=6)
    before = dict(W.LAUNCHES)
    o, s_t, states = W.rwkv_scan_states(r, k, v, logw, u, s0, chunk=32)
    want_o, want_s = W.rwkv_scan(r, k, v, logw, u, s0, chunk=32)
    assert torch.equal(o, want_o) and torch.equal(s_t, want_s)
    assert _close(states, ref.wkv_states_ref(k, v, logw, s0,
                                             ref.wkv_step_tokens(32)))
    assert W.LAUNCHES["rwkv_scan_states_f32"] == \
        before["rwkv_scan_states_f32"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 4, 64, 64, 32),
                                   (2, 96, 3, 32, 96, 32)],
                         ids=["mma-64x64", "fma-dk32-dv96"])
def test_wkv_bwd_kernel_on_the_card(card, shape):
    """``rwkv_scan_bwd_f32`` (its state pass, chunk pass and du sum) at
    64 x 64 (the tensor-core products) and at dk != dv: every gradient
    within 1e-4 x max(1, max |plain|) of ``ref.wkv_chunked_bwd_ref``, two
    runs bit-equal, one launch a call."""
    from repro_torch.kernels import rwkv_scan as W
    b, s, h, dk, dv, chunk = shape
    r, k, v, logw, u, s0, do, dsT = _wkv_inputs(b, s, h, dk, dv, seed=7)
    _, s_t, states = W.rwkv_scan_states(r, k, v, logw, u, s0, chunk=chunk)
    before = dict(W.LAUNCHES)
    got = W.rwkv_scan_bwd(r, k, v, logw, u, s0, states, s_t, do, dsT,
                          chunk=chunk)
    again = W.rwkv_scan_bwd(r, k, v, logw, u, s0, states, s_t, do, dsT,
                            chunk=chunk)
    assert W.LAUNCHES["rwkv_scan_bwd_f32"] == \
        before["rwkv_scan_bwd_f32"] + 2
    want = ref.wkv_chunked_bwd_ref(r, k, v, logw, u, s0, do, dsT,
                                   chunk=chunk)
    for name, g, a, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                             again, want):
        assert g.shape == w.shape, name
        assert torch.equal(g, a), name
        assert _close(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [10, 20], ids=["(1, 4)", "(2, 2)"])
def test_wkv_kernels_at_a_ranks_heads(card, heads):
    """rwkv6-3b's 40 heads over model 4 and 2: the scan, its states
    variant and the backward each within 1e-4 x max(1, max |plain|) of
    the plain version."""
    from repro_torch.kernels import rwkv_scan as W
    r, k, v, logw, u, s0, do, dsT = _wkv_inputs(2, 256, heads, 64, 64,
                                                seed=9)
    o, s_t = W.rwkv_scan(r, k, v, logw, u, s0, chunk=32)
    want_o, want_s = ref.wkv_chunked_ref(r, k, v, logw, u, s0, chunk=32)
    assert _close(o, want_o) and _close(s_t, want_s)
    _, s_t, states = W.rwkv_scan_states(r, k, v, logw, u, s0, chunk=32)
    assert _close(states, ref.wkv_states_ref(k, v, logw, s0,
                                             ref.wkv_step_tokens(32)))
    got = W.rwkv_scan_bwd(r, k, v, logw, u, s0, states, s_t, do, dsT,
                          chunk=32)
    want = ref.wkv_chunked_bwd_ref(r, k, v, logw, u, s0, do, dsT, chunk=32)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                          want):
        assert _close(g, w), name


@pytest.mark.cuda
def test_wkv_scan_fn_trains_through_the_kernels(card):
    """``WkvScanFn`` on card tensors launches the states variant and the
    backward (no plain fallback), and its gradients match the plain
    forward's autograd within 1e-4 x max(1, max |plain|)."""
    from repro_torch.kernels import rwkv_scan as W
    r, k, v, logw, u, s0, do, dsT = _wkv_inputs(2, 64, 2, 64, 64, seed=8)
    before = dict(W.LAUNCHES)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u, s0)]
    o, s_t = W.rwkv_scan_with_grad(*leaves, chunk=32)
    got = torch.autograd.grad((o, s_t), leaves, (do, dsT))
    assert W.LAUNCHES["rwkv_scan_states_f32"] == \
        before["rwkv_scan_states_f32"] + 1
    assert W.LAUNCHES["rwkv_scan_bwd_f32"] == before["rwkv_scan_bwd_f32"] + 1
    assert W.LAUNCHES["rwkv_scan_f32"] == before["rwkv_scan_f32"]
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u, s0)]
    o, s_t = ref.wkv_chunked_ref(*leaves, chunk=32)
    want = torch.autograd.grad((o, s_t), leaves, (do, dsT))
    for g, w in zip(got, want):
        assert _close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["decode", "chunk", "pool-decode",
                                  "pool-chunk"])
@pytest.mark.parametrize("d", [16, 24, 64, 128])
def test_paged_bf16_pages_on_the_card(card, form, d):
    """bf16 pages through the decode, chunk and both pool forms (one
    launch of the form's bf16 kernel a call): within 1e-4 x max(1,
    max |plain|) of the plain version on the same pages, length-0 rows
    zero, and at one node the pool form equals the single form."""
    from repro_torch.kernels import paged_attention as PA
    rng = np.random.default_rng(d)
    h, hkv, page, nodes, local = 8, 2, 16, 4, 12
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s, dtype=np.float32)).cuda()
    kp = mk(nodes * local, page, hkv, d).bfloat16()
    vp = mk(nodes * local, page, hkv, d).bfloat16()
    if form.endswith("chunk"):
        lengths = torch.arange(40, dtype=torch.int32, device="cuda") + 49
        lengths[-3:] = 0
        row = torch.from_numpy(rng.permutation(nodes * local)[:6].astype(
            np.int32)).cuda()
        table = row[None].expand(40, 6)
    else:
        lengths = torch.tensor([0, 1, 19, 80, 96], dtype=torch.int32,
                               device="cuda")
        table = torch.from_numpy(np.stack([
            rng.permutation(nodes * local)[:6] for _ in range(5)]).astype(
                np.int32)).cuda()
    q = mk(lengths.shape[0], h, d)
    pool = form.startswith("pool")
    kernel = f"paged_{'pool_' if pool else ''}{form.split('-')[-1]}_bf16"
    before = PA.LAUNCHES[kernel]
    if pool:
        got = PA.paged_attention_pool(q, kp, vp, table, lengths,
                                      n_nodes=nodes, n_local=local)
        one = PA.paged_attention_pool(q, kp, vp, table, lengths, n_nodes=1,
                                      n_local=nodes * local)
        assert torch.equal(one, PA.paged_attention(q, kp, vp, table,
                                                   lengths))
    else:
        got = PA.paged_attention(q, kp, vp, table, lengths)
    want = ref.paged_attention_ref(q, kp, vp, table, lengths)
    assert float((got - want).abs().max()) <= \
        1e-4 * max(1.0, float(want.abs().max()))
    assert not got[lengths == 0].any()
    assert PA.LAUNCHES[kernel] == before + (2 if pool else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("form", ["decode", "chunk"])
def test_window_route_on_the_card(card, code, form):
    """The rank route's one rule on the card: node r's pool form over its
    own window (one node, the table through ``runtime.pool.window_rows``)
    gives node r's partials of the pool form over all windows bit for
    bit, and the plain split partials of the window
    (``ref.paged_pool_split_partials_ref``) within 1e-4 x max(1, max
    |plain|); the nodes merged (``combine_partials``) are the pool
    wrapper's output within 1e-5."""
    from repro_torch.core import kv_tier as tkv
    from repro_torch.kernels import ops
    from repro_torch.runtime.pool import window_rows
    from repro_torch.runtime.serve import combine_partials
    rng = np.random.default_rng(5)
    h, hkv, d, page, nodes, local, per = 32, 8, 64, 16, 4, 20, 2
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s, dtype=np.float32)).cuda()
    k, v = mk(nodes * local, page, hkv, d), mk(nodes * local, page, hkv, d)
    ks = vs = None
    if code == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    elif code != "f32":
        cd, qmax = tkv._CODE[code]
        k, ks = tkv.quantize_page_kv(k, qmax, cd)
        v, vs = tkv.quantize_page_kv(v, qmax, cd)
    if form == "chunk":
        lengths = torch.arange(48, dtype=torch.int32, device="cuda") + 100
        row = torch.from_numpy(rng.permutation(nodes * local)[:10].astype(
            np.int32)).cuda()
        table = row[None].expand(48, 10)
    else:
        lengths = torch.tensor([0, 1, 37, 160, 96, 155], dtype=torch.int32,
                               device="cuda")
        table = torch.from_numpy(np.stack([
            rng.permutation(nodes * local)[:10] for _ in range(6)]).astype(
                np.int32)).cuda()
    q = mk(lengths.shape[0], h, d)
    acc, m, l = ops.pool_partials(q, k, v, table, lengths, ks, vs,
                                  n_nodes=nodes, n_local=local,
                                  pages_per_split=per)
    parts = []
    for r in range(nodes):
        sl = slice(r * local, (r + 1) * local)
        win = (window_rows(table[0], r, local)[None].expand(table.shape)
               if form == "chunk" else window_rows(table, r, local))
        wk, wv = k[sl], v[sl]
        wks, wvs = (None, None) if ks is None else (ks[sl], vs[sl])
        got = ops.pool_partials(q, wk, wv, win, lengths, wks, wvs, n_nodes=1,
                                n_local=local, pages_per_split=per)
        for a, w in zip(got, (acc[:, :, r:r + 1], m[:, :, r:r + 1],
                              l[:, :, r:r + 1])):
            assert torch.equal(a, w)
        plain = ref.paged_pool_split_partials_ref(
            q, wk, wv, win, lengths, 1, local,
            win.shape[1] if form == "chunk" else per, wks, wvs)
        a_k, m_k, l_k = (x[:, :, 0] for x in got)
        a_p, m_p, l_p = plain
        lim = 1e-4 * max(1.0, float(a_p.abs().max()))
        assert float((a_k - a_p).abs().max()) <= lim
        assert torch.equal(m_k == -1e30, m_p == -1e30)
        parts.append(ref.merge_split_partials(a_k, m_k, l_k))
    merged = combine_partials(*(torch.stack(x) for x in zip(*parts)))
    whole = (ops.paged_attention_pool(q, k, v, table, lengths,
                                      n_nodes=nodes, n_local=local)
             if ks is None else
             ops.paged_attention_pool_q8(q, k, v, ks, vs, table, lengths,
                                         n_nodes=nodes, n_local=local))
    assert float((merged - whole).abs().max()) <= 1e-5


def _rank_spec(n):
    import dataclasses
    from repro_torch.configs.base import get_arch
    cfg = dataclasses.replace(get_arch("granite_3_2b").reduced(),
                              n_layers=2, vocab_size=64)
    rng = np.random.default_rng(0)
    return {"cfg": dataclasses.asdict(cfg), "seed": 0, "device": "cuda",
            "prompts": [rng.integers(0, 64, 40).tolist() for _ in range(5)],
            "gens": [12] * 5, "chunk": 16,
            "server": {"page_size": 16, "hbm_pages_per_node": 32 // n}}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4])
def test_pool_ranks_share_the_card(card, tmp_path, n):
    """``PoolServer(mesh=...)`` with ``n`` ranks on the one card over gloo
    (``launch.mesh.run_ranks``): tokens equal to the one-process pool of
    ``n`` nodes, prefill and step logits within 1e-4 (bit-equal at one
    rank), every rank the same bits; the pool form launched on every
    rank."""
    from repro_torch.launch.mesh import run_ranks
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    from pool_sessions import pool_session
    spec = _rank_spec(n)
    single = pool_session(dict(spec, nodes=n))
    ranks = run_ranks(pool_session, n, (dict(spec, ranks=True),),
                      device_type="cuda", timeout_s=240,
                      workdir=str(tmp_path))
    for r in ranks:
        assert r["tokens"] == single["tokens"] == ranks[0]["tokens"]
        for a, b in zip(r["prefill"], ranks[0]["prefill"]):
            assert torch.equal(a, b)
        err = max(float((a - b).abs().max()) for a, b in
                  zip(r["prefill"], single["prefill"]))
        assert err == 0.0 if n == 1 else err <= 1e-4
        assert r["launches"].get("paged_pool_decode_f32", 0) > 0
        assert r["launches"].get("paged_pool_chunk_f32", 0) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("suffix", [1, 8, 16, 40])
def test_short_prefill_chunks_pad_to_min_rows(card, monkeypatch, suffix):
    """On the card a prefill chunk runs at least ``PREFILL_MIN_ROWS_CUDA``
    rows: a cached prefix plus ``suffix`` new tokens gives the logits of
    the chunk at its bare pow2 bucket within 1e-5 (the padding is masked;
    only cuBLAS's kernel for the products changes), and the chunk's
    tokens are the rows the server ran."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.models.api import get_model
    from repro_torch.runtime import serve as S

    cfg = dataclasses.replace(get_arch("granite-3-2b"), n_layers=2,
                              d_model=128, n_heads=8, n_kv_heads=4,
                              d_ff=256, vocab_size=512)
    model = get_model(cfg, compute_dtype=torch.float32)
    params = model.init(torch.Generator(device=card).manual_seed(0),
                        device=card)
    rng = np.random.default_rng(suffix)
    prefix = rng.integers(0, 512, 32, dtype=np.int32)
    prompt = np.concatenate([prefix,
                             rng.integers(0, 512, suffix, dtype=np.int32)])
    rows = []
    inner = S.PagedServer.prefill_chunk_step

    def seen(self, page_row, tokens, start, n_valid):
        rows.append(tokens.shape[1])
        return inner(self, page_row, tokens, start, n_valid)
    monkeypatch.setattr(S.PagedServer, "prefill_chunk_step", seen)
    out, least = {}, S.PREFILL_MIN_ROWS_CUDA
    for min_rows in (least, 1):
        monkeypatch.setattr(S, "PREFILL_MIN_ROWS_CUDA", min_rows)
        srv = S.PagedServer(model, params, page_size=8, hbm_pages=32,
                            device=card)
        srv.add_request(0, prefix)
        srv.free_sequence(0)
        out[min_rows] = srv.add_request(1, prompt)
    bucket = 1 << (suffix - 1).bit_length()
    assert rows[1] == max(bucket, least)
    assert rows[3] == bucket
    err = float((out[1] - out[least]).abs().max())
    assert err <= 1e-5 * max(1.0, float(out[1].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_mesh_ranks_share_the_card(card, tmp_path, mesh):
    """The dense model over a ``(data, model)`` mesh of 2 gloo ranks on the
    card (``scripts/mesh_sessions.py``, reduced granite-3-2b): a train
    step (grad-accum 2, remat full) and greedy serving with the cache
    sequence-sharded over ``model`` (f32 and int8), each held by rank 0
    to the same work in one process; the flash kernels launched on every
    rank."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.mesh import run_ranks
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    from mesh_sessions import mesh_sessions
    cfg = dataclasses.asdict(get_arch("granite_3_2b").reduced())
    rng = np.random.default_rng(0)
    base = {"cfg": cfg, "seed": 0, "device": "cuda", "mesh": mesh,
            "twin": True}
    batch = {"tokens": rng.integers(0, 128, (8, 64)),
             "labels": rng.integers(-1, 128, (8, 64))}
    prompts = rng.integers(0, 128, (4, 60))
    cases = [dict(base, kind="train", batches=[batch], ga=2, remat="full"),
             dict(base, kind="serve", kv="f32", prompts=prompts,
                  cache_len=64, gen=4),
             dict(base, kind="serve", kv="int8", prompts=prompts,
                  cache_len=64, gen=4)]
    got = run_ranks(mesh_sessions, 2, (cases,), device_type="cuda",
                    timeout_s=240, workdir=str(tmp_path))
    train, f32, q8 = got[0]
    assert train["twin"]["loss_rel_err"] <= 1e-5
    assert f32["twin"]["tokens_equal"] and q8["twin"]["tokens_equal"]
    for r in got:
        assert r[0]["launches"].get("flash_attention_bwd_f32", 0) > 0
        assert r[1]["launches"].get("flash_attention_f32", 0) > 0
