"""The decode form's split arithmetic and the chunk form's table, on the
CPU: the plain emulation of the split partials (``ref.
paged_split_partials_ref``) against the reference's
``paged_attention_partial`` per split, its merge against the
reference's ``combine_partials`` and the Pallas kernels in interpret
mode, the wrappers over an expanded (stride-0) table against a
contiguous one, and ``PagedServer`` prefill through the expanded table
against the JAX server, all on the same numpy inputs.  Also the shapes
the kernels take (``kernel_takes``): every configuration's, full and
reduced, and the split arithmetic at head_dim 16, pages of 128 and a
group of 64."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.runtime.serve import PagedServer as JServer  # noqa: E402
from repro.runtime.serve import combine_partials  # noqa: E402
from repro.runtime.serve import paged_attention_partial  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, ArchConfig  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core import kv_tier as tkv  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime.serve import PagedServer  # noqa: E402

# f32 on both sides; only the summation order (and, for codes, where the
# scale multiplies) differs
TOL = 1e-5
H, HKV, D, PAGE, N_PHYS, PPS = 8, 2, 16, 4, 40, 8
# a length-0 row, rows that end inside the first split (later splits lie
# wholly past them), a partial last page, and a full table
LENGTHS = [0, 1, 5, 13, 32, 20, 9]
DTYPES = ["f32", "int8", "fp8"]


def _inputs(seed, lengths=LENGTHS, pps=PPS, h=H, hkv=HKV, d=D, page=PAGE,
            n_phys=N_PHYS):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((n_phys, page, hkv, d)).astype(np.float32)
    v = rng.standard_normal((n_phys, page, hkv, d)).astype(np.float32)
    table = np.zeros((b, pps), np.int32)
    for i, n in enumerate(lengths):
        used = -(-n // page)
        table[i, :used] = rng.choice(n_phys, used, replace=False)
    return q, k, v, table, np.asarray(lengths, np.int32)


def _pages(k, v, dtype):
    """(torch k, v, k_scale, v_scale) and their JAX twins; codes cross to
    JAX as bytes, reinterpreted on its side."""
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if dtype == "f32":
        return (kt, vt, None, None), (jnp.asarray(k), jnp.asarray(v), None,
                                      None)
    code, qmax = tkv._CODE[dtype]
    kq, ks = tkv.quantize_page_kv(kt, qmax, code)
    vq, vs = tkv.quantize_page_kv(vt, qmax, code)
    jcode = jnp.int8 if dtype == "int8" else jnp.float8_e4m3fn

    def j(x):
        return jax.lax.bitcast_convert_type(
            jnp.asarray(x.view(torch.uint8).numpy()), jcode)
    return ((kq, vq, ks, vs),
            (j(kq), j(vq), jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy())))


def _per(n_splits, pps=PPS):
    return -(-pps // n_splits)


@pytest.mark.parametrize("b,hkv,pps,n_sm", [
    (8, 8, 64, 132),      # the serve phase's decode: 8 splits of 8 pages
    (1, 8, 256, 132),     # one long row: many splits of few pages
    (256, 8, 32, 132),    # a contiguous prefill chunk fills the card alone
    (3, 2, 7, 132),       # an odd table: no split empty of columns
    (2, 4, 1, 132),       # a one-page table cannot split
])
def test_split_plan_covers_the_table(b, hkv, pps, n_sm):
    splits, per = tpa.split_plan(b, hkv, pps, n_sm)
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < pps <= splits * per
    if splits > 1:
        assert per >= tpa.MIN_SPLIT_PAGES
        # no more splits than the blocks-per-SM aim asks for
        assert b * hkv * (splits - 1) < tpa.SPLIT_BLOCKS_PER_SM * n_sm
    else:
        assert (b * hkv >= tpa.SPLIT_BLOCKS_PER_SM * n_sm or
                pps < 2 * tpa.MIN_SPLIT_PAGES)


def test_split_plan_values():
    assert tpa.split_plan(8, 8, 64, 132) == (8, 8)
    assert tpa.split_plan(1, 8, 256, 132) == (64, 4)
    assert tpa.split_plan(256, 8, 32, 132) == (1, 32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_splits", [1, 2, 3])
def test_split_partials_match_reference_partial(n_splits, dtype):
    q, k, v, table, lens = _inputs(0)
    (kt, vt, ks, vs), (jk, jv, jks, jvs) = _pages(k, v, dtype)
    per = _per(n_splits)
    acc, m, l = tops.ref.paged_split_partials_ref(
        torch.from_numpy(q), kt, vt, torch.from_numpy(table),
        torch.from_numpy(lens), per, ks, vs)
    assert acc.shape == (len(LENGTHS), H, n_splits, D)
    col = np.arange(PPS)
    for s in range(n_splits):
        owned = np.broadcast_to((col >= s * per) & (col < (s + 1) * per),
                                table.shape)
        wacc, wm, wl = paged_attention_partial(
            jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(owned),
            jnp.asarray(lens), jks, jvs)
        np.testing.assert_allclose(acc[:, :, s].numpy(), np.asarray(wacc),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(m[:, :, s].numpy(), np.asarray(wm),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(l[:, :, s].numpy(), np.asarray(wl),
                                   atol=TOL, rtol=TOL)
        # a split wholly past a row's length drops out as (0, -1e30, 0)
        past = lens <= s * per * PAGE
        assert not acc[past, :, s].any() and not l[past, :, s].any()
        assert (m[past, :, s] == tops.ref.NEG_INF).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_splits", [1, 2, 3])
def test_split_merge_matches_combine_partials_and_pallas(n_splits, dtype):
    q, k, v, table, lens = _inputs(1)
    (kt, vt, ks, vs), (jk, jv, jks, jvs) = _pages(k, v, dtype)
    parts = tops.ref.paged_split_partials_ref(
        torch.from_numpy(q), kt, vt, torch.from_numpy(table),
        torch.from_numpy(lens), _per(n_splits), ks, vs)
    got = tops.ref.combine_splits_ref(*parts).numpy()
    merged = jax.vmap(functools.partial(combine_partials, axis_name="s"),
                      in_axes=(2, 2, 2), axis_name="s")(
        *(jnp.asarray(x.numpy()) for x in parts))[0]
    np.testing.assert_allclose(got, np.asarray(merged), atol=TOL, rtol=TOL)
    if dtype == "f32":
        want = jops.paged_attention(jnp.asarray(q), jk, jv,
                                    jnp.asarray(table), jnp.asarray(lens),
                                    interpret=True)
    else:
        want = jops.paged_attention_q8(jnp.asarray(q), jk, jv, jks, jvs,
                                       jnp.asarray(table), jnp.asarray(lens),
                                       interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
    assert not got[lens == 0].any()


# (H, Hkv, D, page, pps, lengths): the reduced configs' head_dim 16 over
# pages of 128 (two decode tiles a page), a GQA group of 64 (two decode
# blocks a kv head), head_dim 80 (hubert-xlarge; an instantiation of 96
# with 16 zero columns), head_dim 24 (codes copied in 8-byte pieces)
WIDE_SHAPES = [(4, 1, 16, 128, 4, [0, 1, 127, 128, 300, 512]),
               (64, 1, 16, 8, 6, [0, 5, 8, 47, 48]),
               (128, 2, 16, 16, 4, [3, 64, 17]),
               (8, 2, 80, 16, 4, [0, 16, 40, 64]),
               (8, 4, 24, 8, 4, [1, 9, 32])]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=[
    f"H{s[0]}-Hkv{s[1]}-D{s[2]}-page{s[3]}" for s in WIDE_SHAPES])
def test_split_arithmetic_at_the_shapes_the_kernels_now_take(shape, dtype):
    """The decode form's split partials and their merge at head_dims,
    pages and groups the card refused before, within 1e-4 of the
    reference's paged_attention_partial / combine_partials and the
    Pallas kernels in interpret mode."""
    h, hkv, d, page, pps, lengths = shape
    assert tpa.kernel_takes(d, page, h // hkv)
    q, k, v, table, lens = _inputs(7, lengths, pps, h, hkv, d, page, 24)
    (kt, vt, ks, vs), (jk, jv, jks, jvs) = _pages(k, v, dtype)
    tol = 1e-4
    for n_splits in (1, 2):
        per = _per(n_splits, pps)
        parts = tops.ref.paged_split_partials_ref(
            torch.from_numpy(q), kt, vt, torch.from_numpy(table),
            torch.from_numpy(lens), per, ks, vs)
        col = np.arange(pps)
        for s in range(parts[0].shape[2]):
            owned = np.broadcast_to((col >= s * per) & (col < (s + 1) * per),
                                    table.shape)
            want = paged_attention_partial(
                jnp.asarray(q), jk, jv, jnp.asarray(table),
                jnp.asarray(owned), jnp.asarray(lens), jks, jvs)
            for got, w in zip(parts, want):
                np.testing.assert_allclose(got[:, :, s].numpy(),
                                           np.asarray(w), atol=tol, rtol=tol)
        got = tops.ref.combine_splits_ref(*parts).numpy()
        merged = jax.vmap(functools.partial(combine_partials, axis_name="s"),
                          in_axes=(2, 2, 2), axis_name="s")(
            *(jnp.asarray(x.numpy()) for x in parts))[0]
        np.testing.assert_allclose(got, np.asarray(merged), atol=tol,
                                   rtol=tol)
    if dtype == "f32":
        want = jops.paged_attention(jnp.asarray(q), jk, jv,
                                    jnp.asarray(table), jnp.asarray(lens),
                                    interpret=True)
    else:
        want = jops.paged_attention_q8(jnp.asarray(q), jk, jv, jks, jvs,
                                       jnp.asarray(table), jnp.asarray(lens),
                                       interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)
    assert not got[lens == 0].any()


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_kernel_takes_every_configs_attention(arch, reduced):
    """Every configuration's head_dim and GQA group, full and reduced()
    (head_dim 16), at the serving pages (16) and at 128."""
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    for page in (16, 128):
        assert tpa.kernel_takes(cfg.hd, page, cfg.n_heads // cfg.n_kv_heads)


@pytest.mark.parametrize("d,page,group,takes", [
    (8, 1, 1, True), (16, 128, 64, True), (80, 256, 4, True),
    (256, 1024, 32, True), (24, 16, 8, True), (12, 16, 1, False),
    (264, 16, 1, False), (0, 16, 1, False), (64, 1025, 1, False),
    (64, 0, 1, False), (64, 16, 65, False), (64, 16, 0, False)])
def test_paged_kernel_takes_bounds(d, page, group, takes):
    assert tpa.kernel_takes(d, page, group) is takes


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_partials_wrapper_on_cpu_is_the_emulation(dtype):
    q, k, v, table, lens = _inputs(2)
    (kt, vt, ks, vs), _ = _pages(k, v, dtype)
    args = (torch.from_numpy(q), kt, vt, torch.from_numpy(table),
            torch.from_numpy(lens))
    got = tpa.split_partials(*args, ks, vs, pages_per_split=3)
    want = tops.ref.paged_split_partials_ref(*args, 3, ks, vs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    full = (tops.paged_attention(*args) if ks is None else
            tops.paged_attention_q8(args[0], kt, vt, ks, vs, *args[3:]))
    np.testing.assert_allclose(tops.ref.combine_splits_ref(*got).numpy(),
                               full.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n_splits", [1, 3])
def test_combine_splits_on_cpu_is_the_plain_merge(n_splits):
    q, k, v, table, lens = _inputs(5)
    acc, m, l = tops.ref.paged_split_partials_ref(
        *map(torch.from_numpy, (q, k, v, table, lens)), _per(n_splits))
    assert torch.equal(tpa.combine_splits(acc, m, l),
                       tops.ref.combine_splits_ref(acc, m, l))
    with pytest.raises(ValueError):
        tpa.combine_splits(acc, m[:, :1], l)
    with pytest.raises(TypeError):
        tpa.combine_splits(acc.double(), m, l)


@pytest.mark.parametrize("dtype", DTYPES)
def test_expanded_table_equals_contiguous(dtype):
    # a prefill chunk: positions 9..20 of one sequence over one page row
    lens = np.arange(10, 22, dtype=np.int32)
    q, k, v, _, _ = _inputs(3, lengths=list(lens))
    row = np.random.default_rng(4).choice(N_PHYS, PPS, replace=False)
    expanded = torch.from_numpy(row.astype(np.int32))[None].expand(
        len(lens), PPS)
    assert expanded.stride(0) == 0 and tpa._shared_row(expanded)
    contiguous = expanded.contiguous()
    assert not tpa._shared_row(contiguous)
    (kt, vt, ks, vs), _ = _pages(k, v, dtype)
    qt, lt = torch.from_numpy(q), torch.from_numpy(lens)
    outs = []
    for table in (expanded, contiguous):
        if ks is None:
            outs.append(tops.paged_attention(qt, kt, vt, table, lt))
        else:
            outs.append(tops.paged_attention_q8(qt, kt, vt, ks, vs, table,
                                                lt))
    assert torch.equal(outs[0], outs[1])


def test_only_an_expanded_row_is_a_shared_row():
    t = torch.zeros((4, 6), dtype=torch.int32)
    assert not tpa._shared_row(t)
    assert not tpa._shared_row(t.t())                # transposed
    assert not tpa._shared_row(t[:, ::2])            # strided columns
    assert tpa._shared_row(t[0][None].expand(4, 6))
    assert not tpa._shared_row(t[:, 0][:, None].expand(4, 6))


@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(jget_arch("granite_3_2b").reduced(),
                              n_layers=2, vocab_size=64)
    jmodel = jget_model(cfg, compute_dtype=jnp.float32, moe_no_drop=True)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(ArchConfig(**dataclasses.asdict(cfg)))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return cfg, (jmodel, jparams), (tmodel, tparams)


@pytest.mark.parametrize("page_dtype", ["fp32", "int8"])
def test_prefill_chunks_attend_through_an_expanded_row(models, monkeypatch,
                                                       page_dtype):
    cfg, (jm, jp), (tm, tp) = models
    kw = dict(page_size=4, hbm_pages=32, page_dtype=page_dtype)
    js = JServer(jm, jp, dtype=jnp.float32, **kw)
    ts = PagedServer(tm, tp, device="cpu", **kw)
    seen = []
    inner = ts._kernel_attention

    def spy(q, li, page_table, lengths):
        seen.append((page_table.shape, page_table.stride()))
        return inner(q, li, page_table, lengths)
    monkeypatch.setattr(ts, "_kernel_attention", spy)
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 11), dtype=np.int32)
    for i, p in enumerate(prompts):
        want = np.asarray(js.add_request(i, p, chunk=4))
        got = ts.add_request(i, p, chunk=4).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # 2 prompts x 3 chunks x 2 layers, each over one expanded page row
    assert len(seen) == 12
    assert all(shape[0] == 4 and stride[0] == 0 for shape, stride in seen)
    assert ts.decode(5, horizon=1) == js.decode(5, horizon=1)
