"""The pool form's work plan and its split partials, on the CPU, against
the JAX package on the same numpy inputs.

The pool kernels walk only the pages a node owns: a block lists, in
ascending order, the logical pages of its row whose physical page lies
in its node's window (``ref.pool_owned_pages``); the decode form's split
t of node s takes the listed pages of rank ``[t * per, (t + 1) * per)``
(``ref.pool_split_owned``), the chunk form's tiles run over the node's
listed keys (``ref.pool_chunk_tiles``).  Here: the plan covers each
owned key below the length exactly once, in ascending order, over
placed, striped and random tables at pages of 4, 16 and 128, and at one
node it is the single forms' tiles and splits; the split emulation
(``ref.paged_pool_split_partials_ref``) split by split and merged per
node against the reference's ``paged_attention_partial`` with that
``col_owned``, merged across nodes against its ``combine_partials``; a
node that owns nothing gives (0, -1e30, 0) in every split; and at one
node the emulation is the single decode form's
(``ref.paged_split_partials_ref``) bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.runtime import serve as jserve  # noqa: E402
from repro_torch.core import kv_tier as tkv  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# f32 on both sides; only the summation order (and, for codes, where the
# scale multiplies) differs
TOL = 1e-5
DTYPES = ["f32", "int8", "fp8"]
POLICIES = ["placed", "striped", "random"]
PAGES = [4, 16, 128]
N_NODES, N_LOCAL, H, HKV, D, PPS = 4, 12, 8, 2, 16, 8


def _lengths(page):
    # a padding row, one token, rows ending inside a page, a full table
    return [0, 1, 5, 3 * page + 2, PPS * page, 5 * page]


def _table(rng, lengths, page, policy, n_nodes=N_NODES, n_local=N_LOCAL):
    """[B, PPS] global ids, no page twice, each row's pages by ``policy``
    (placed: row i on node i % N; striped: logical page j on node j % N;
    random); columns past a row's pages hold 0, which the kernels never
    read."""
    free = [list(rng.permutation(n_local) + s * n_local)
            for s in range(n_nodes)]
    table = np.zeros((len(lengths), PPS), np.int32)
    for i, n in enumerate(lengths):
        for j in range(-(-n // page)):
            s = {"placed": i, "striped": j,
                 "random": int(rng.integers(n_nodes))}[policy] % n_nodes
            table[i, j] = free[s].pop()
    return table


def _inputs(seed, page, policy, n_nodes=N_NODES, n_local=N_LOCAL):
    rng = np.random.default_rng(seed)
    lengths = _lengths(page)
    n_phys = n_nodes * n_local
    q = rng.standard_normal((len(lengths), H, D)).astype(np.float32)
    k = rng.standard_normal((n_phys, page, HKV, D)).astype(np.float32)
    v = rng.standard_normal((n_phys, page, HKV, D)).astype(np.float32)
    return (q, k, v, _table(rng, lengths, page, policy, n_nodes, n_local),
            np.asarray(lengths, np.int32))


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


def _owned_positions(row, kmax, page, node):
    """Every position below ``kmax`` whose page the node owns, by brute
    force over the row."""
    return [p for p in range(kmax)
            if node * N_LOCAL <= row[p // page] < (node + 1) * N_LOCAL]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page", PAGES)
@pytest.mark.parametrize("policy", POLICIES)
def test_plan_covers_each_owned_key_once_in_order(policy, page):
    """Per node: the list is the owned columns below the length, in
    ascending order; the chunk tiles hold exactly the owned positions
    below kmax, ascending, ``kt`` a tile (the last one shorter); the
    decode splits cut the list into ranks of ``per`` without overlap.
    Across the nodes every position below the length is walked once."""
    _, _, _, table, lengths = _inputs(0, page, policy)
    kt = tref.chunk_tile_keys(D)
    for row, n in zip(table, lengths):
        walked = []
        for s in range(N_NODES):
            lst = tref.pool_owned_pages(row, n, page, s, N_LOCAL).tolist()
            n_cols = -(-int(n) // page)
            assert lst == [c for c in range(n_cols)
                           if s * N_LOCAL <= row[c] < (s + 1) * N_LOCAL]
            tiles = tref.pool_chunk_tiles(row, int(n), page, s, N_LOCAL, kt)
            keys = [int(p) for t in tiles for p in t]
            assert keys == _owned_positions(row, int(n), page, s)
            assert all(len(t) == kt for t in tiles[:-1])
            assert not tiles or 1 <= len(tiles[-1]) <= kt
            walked += keys
        assert sorted(walked) == list(range(n))
    for per in (1, 2, 3, PPS):
        lens_t = torch.from_numpy(lengths)
        tab_t = torch.from_numpy(table)
        masks = [tref.pool_split_owned(tab_t, lens_t, page, s, N_LOCAL, per, t)
                 for s in range(N_NODES) for t in range(-(-PPS // per))]
        hits = torch.stack(masks).long().sum(0)
        n_pages = -(-lens_t.long() // page)
        assert torch.equal(hits, (torch.arange(PPS)[None] <
                                  n_pages[:, None]).long())
        for s in range(N_NODES):
            for t in range(-(-PPS // per)):
                m = masks[s * -(-PPS // per) + t]
                for i, row in enumerate(table):
                    lst = tref.pool_owned_pages(row, lengths[i], page, s,
                                                N_LOCAL).tolist()
                    assert torch.nonzero(m[i]).flatten().tolist() == \
                        lst[t * per:(t + 1) * per]


@pytest.mark.parametrize("page", PAGES)
def test_plan_at_one_node_is_the_single_forms(page):
    """One node whose window is the store: the list is 0, 1, ...; the
    chunk tiles are [0, kt), [kt, 2 kt), ... below kmax; split t walks
    the columns [t * per, (t + 1) * per) below the length."""
    _, _, _, table, lengths = _inputs(1, page, "random")
    n_phys = N_NODES * N_LOCAL
    for kt in (32, 64):
        for row, n in zip(table, lengths):
            assert tref.pool_owned_pages(row, n, page, 0, n_phys).tolist() \
                == list(range(-(-int(n) // page)))
            tiles = tref.pool_chunk_tiles(row, int(n), page, 0, n_phys, kt)
            assert [t.tolist() for t in tiles] == [
                list(range(a, min(a + kt, n))) for a in range(0, n, kt)]
    col = torch.arange(PPS)[None]
    n_pages = -(-torch.from_numpy(lengths).long() // page)[:, None]
    for per in (1, 3, PPS):
        for t in range(-(-PPS // per)):
            got = tref.pool_split_owned(torch.from_numpy(table),
                                        torch.from_numpy(lengths), page, 0,
                                        n_phys, per, t)
            assert torch.equal(got, (col >= t * per) &
                               (col < (t + 1) * per) & (col < n_pages))


@pytest.mark.parametrize("d,kt", [(8, 64), (16, 64), (64, 64), (96, 64),
                                  (128, 64), (136, 32), (256, 32)])
def test_chunk_tile_keys(d, kt):
    assert tref.chunk_tile_keys(d) == kt


def test_pool_groups():
    """One ticket a group: the decode form's (row, kv head, head part of
    at most 32), the chunk form's (tile of 64 // G positions, kv head)."""
    assert tpa.pool_groups("decode", 8, 32, 8) == 64
    assert tpa.pool_groups("decode", 3, 64, 1) == 6
    assert tpa.pool_groups("chunk", 256, 32, 8) == 128
    assert tpa.pool_groups("chunk", 40, 64, 1) == 40
    assert tpa.pool_groups("chunk", 5, 8, 8) == 8


# ---------------------------------------------------------------------------
# the split partials against the reference
# ---------------------------------------------------------------------------

def _per_split(acc, m, l, n_splits):
    b, h, _, d = acc.shape
    return (acc.view(b, h, N_NODES, n_splits, d),
            m.view(b, h, N_NODES, n_splits), l.view(b, h, N_NODES, n_splits))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_partials_match_reference_partial(dtype, policy):
    """Each (node, split) partial of the emulation equals the reference's
    ``paged_attention_partial`` with that split's ``col_owned``; merged
    per node it equals the reference's partial over the node's window
    (its own local pages and local table)."""
    page, per = 4, 2
    q, k, v, table, lengths = _inputs(2, page, policy)
    (kt, vt, kst, vst), (kj, vj, ksj, vsj) = _pages(k, v, dtype)
    qt, tt, lt = (torch.from_numpy(x) for x in (q, table, lengths))
    n_splits = -(-PPS // per)
    acc, m, l = _per_split(*tref.paged_pool_split_partials_ref(
        qt, kt, vt, tt, lt, N_NODES, N_LOCAL, per, kst, vst), n_splits)
    for s in range(N_NODES):
        for t in range(n_splits):
            owned = tref.pool_split_owned(tt, lt, page, s, N_LOCAL, per, t)
            want = jserve.paged_attention_partial(
                jnp.asarray(q), kj, vj, jnp.asarray(table),
                jnp.asarray(owned.numpy()), jnp.asarray(lengths),
                k_scale=ksj, v_scale=vsj)
            for g, w in zip((acc[:, :, s, t], m[:, :, s, t], l[:, :, s, t]),
                            want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=TOL, atol=TOL)
        local = table - s * N_LOCAL
        win = (local >= 0) & (local < N_LOCAL)
        sl = slice(s * N_LOCAL, (s + 1) * N_LOCAL)
        want = jserve.paged_attention_partial(
            jnp.asarray(q), kj[sl], vj[sl], jnp.asarray(local),
            jnp.asarray(win), jnp.asarray(lengths),
            k_scale=None if ksj is None else ksj[sl],
            v_scale=None if vsj is None else vsj[sl])
        got = tref.merge_split_partials(acc[:, :, s], m[:, :, s], l[:, :, s])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                       atol=TOL)


@pytest.mark.parametrize("policy", POLICIES)
def test_merge_across_nodes_matches_combine_partials(policy):
    """The node-merged partials across the pool axis against the
    reference's ``combine_partials`` (``pmax`` + ``psum`` under
    ``jax.vmap`` with an axis name); the N * S partials merged at once
    (what the kernels' merge does) give the same output."""
    page, per = 16, 3
    q, k, v, table, lengths = _inputs(3, page, policy)
    qt, kt, vt, tt, lt = (torch.from_numpy(x)
                          for x in (q, k, v, table, lengths))
    flat = tref.paged_pool_split_partials_ref(qt, kt, vt, tt, lt, N_NODES,
                                              N_LOCAL, per)
    acc, m, l = tref.merge_split_partials(*_per_split(*flat, -(-PPS // per)))
    want = jax.vmap(lambda a, mm, ll: jserve.combine_partials(a, mm, ll, "n"),
                    axis_name="n")(jnp.asarray(acc.movedim(2, 0).numpy()),
                                   jnp.asarray(m.movedim(2, 0).numpy()),
                                   jnp.asarray(l.movedim(2, 0).numpy()))[0]
    for got in (tref.combine_splits_ref(acc, m, l),
                tref.combine_splits_ref(*flat)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        assert torch.isfinite(got).all() and not got[0].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_node_owning_nothing_is_the_identity(dtype):
    """Every row placed on nodes 0 and 1: nodes 2 and 3 give (0, -1e30,
    0) in every split, as does every split past a row's owned pages."""
    page, per = 4, 2
    q, k, v, _, lengths = _inputs(4, page, "placed")
    rng = np.random.default_rng(4)
    table = _table(rng, list(lengths), page, "placed", n_nodes=2,
                   n_local=N_LOCAL)
    (kt, vt, kst, vst), _ = _pages(k, v, dtype)
    n_splits = -(-PPS // per)
    acc, m, l = _per_split(*tref.paged_pool_split_partials_ref(
        torch.from_numpy(q), kt, vt, torch.from_numpy(table),
        torch.from_numpy(lengths), N_NODES, N_LOCAL, per, kst, vst), n_splits)
    assert not acc[:, :, 2:].any() and not l[:, :, 2:].any()
    assert (m[:, :, 2:] == tref.NEG_INF).all()
    for i, row in enumerate(table):
        for s in range(N_NODES):
            n_own = tref.pool_owned_pages(row, lengths[i], page, s,
                                          N_LOCAL).numel()
            past = slice(-(-n_own // per), None)
            assert not acc[i, :, s, past].any() and not l[i, :, s, past].any()
            assert (m[i, :, s, past] == tref.NEG_INF).all()


@pytest.mark.parametrize("per", [1, 3, PPS])
@pytest.mark.parametrize("dtype", DTYPES)
def test_one_node_is_the_single_split_emulation(dtype, per):
    """At one node whose window is the store, the pool split emulation is
    the single decode form's (``ref.paged_split_partials_ref``) bit for
    bit, as the pool kernels are the single forms'."""
    q, k, v, table, lengths = _inputs(5, 4, "random")
    (kt, vt, kst, vst), _ = _pages(k, v, dtype)
    qt, tt, lt = (torch.from_numpy(x) for x in (q, table, lengths))
    got = tref.paged_pool_split_partials_ref(qt, kt, vt, tt, lt, 1,
                                             N_NODES * N_LOCAL, per, kst, vst)
    want = tref.paged_split_partials_ref(qt, kt, vt, tt, lt, per, kst, vst)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
