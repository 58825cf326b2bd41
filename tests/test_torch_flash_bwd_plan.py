"""The flash backward's block schedule and sum order (CPU).

``ref.flash_bwd_plan`` is the tensor-core route's schedule, shared by the
wrapper (workspace, tickets) and ``chip_smoke.py``: dK/dV blocks of
(batch, head, key tile) walking query tiles, the G heads' shares merged
head 0 first, dQ blocks of (batch, kv head, positions) walking key
tiles.  Held here: every kept (query, key) pair of every head reaches
dK/dV once and dQ once, and no walked tile is wholly masked;
``ref.flash_attention_bwd_emulated`` (that order, 3xTF32 products)
against float64 autograd and against ``jax.vjp`` of the reference's
``chunked_attention``.  The kernel itself runs on the card only
(``chip_smoke.py``, ``tests/test_torch_card.py``)."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.build import CSRC  # noqa: E402

JAX_TOL = 1e-5           # f32 both sides; only summation orders differ
F64_TOL = 1e-4           # x max(1, max |float64|), as chip_smoke.BWD_TOL

LENGTHS = (1, 33, 65, 513)
GROUPS = (1, 4, 8, 64)
HEAD_DIMS = (8, 64, 96, 128)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several test processes
    on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kept(i0, i1, j0, j1, causal):
    """[i1 - i0, j1 - j0] bool: the pairs of query rows [i0, i1) and keys
    [j0, j1) that attention keeps."""
    i = np.arange(i0, i1)[:, None]
    j = np.arange(j0, j1)[None, :]
    return (j <= i) if causal else np.ones((i1 - i0, j1 - j0), bool)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plan_reaches_each_kept_pair_once(causal, length, group, d):
    hkv = {1: 3, 4: 2, 8: 2, 64: 1}[group]
    b, h = (1 if length > 65 else 2), group * hkv
    sq, sk = length, (length if causal else length + 31)
    plan = ref.flash_bwd_plan(b, h, hkv, sq, sk, d)
    rows, cols = ref.FLASH_BWD_ROWS, plan.cols
    want = np.broadcast_to(_kept(0, sq, 0, sk, causal), (b, h, sq, sk))

    # dK/dV: each block's walk, key tile 0's blocks first
    seen = np.zeros((b, h, sq, sk), np.int16)
    blocks = ref.flash_bwd_dkdv_blocks(plan, b, h)
    assert len(blocks) == plan.dkdv_blocks == b * h * plan.key_tiles
    walks = []
    for bb, head, kt in blocks:
        j0, j1 = kt * rows, min(kt * rows + rows, sk)
        walk = ref.flash_bwd_dkdv_walk(plan, kt, sq, causal)
        walks.append(len(walk))
        for t in walk:
            i0, i1 = t * cols, min(t * cols + cols, sq)
            kept = _kept(i0, i1, j0, j1, causal)
            assert kept.any(), f"walked tile {t} of key tile {kt} is masked"
            seen[bb, head, i0:i1, j0:j1] += kept
    assert walks == sorted(walks, reverse=True)      # longest first
    np.testing.assert_array_equal(seen, want)

    # the merge: one ticket a (batch, kv head, key tile) group of G
    # blocks, merged head 0 first; no workspace at G = 1
    groups = {}
    for bb, head, kt in blocks:
        groups.setdefault((bb, head // group, kt), []).append(head % group)
    assert all(heads == list(range(group)) for heads in groups.values())
    merged = group > 1
    assert plan.tickets == (len(groups) if merged else 0)
    assert plan.workspace == (2 * group * b * hkv * sk * d if merged else 0)

    # dQ: each block's rows are the G heads x bq positions
    seen[:] = 0
    blocks = ref.flash_bwd_dq_blocks(plan, b, hkv)
    assert len(blocks) == plan.dq_blocks == b * hkv * plan.query_tiles
    walks = []
    for bb, kvh, q0 in blocks:
        i1 = min(q0 + plan.bq, sq)
        walk = ref.flash_bwd_dq_walk(plan, q0, sq, sk, causal)
        walks.append(len(walk))
        for jt in walk:
            j0, j1 = jt * cols, min(jt * cols + cols, sk)
            kept = _kept(q0, i1, j0, j1, causal)
            assert kept.any(), f"walked key tile {jt} of rows {q0} is masked"
            seen[bb, kvh * group:(kvh + 1) * group, q0:i1, j0:j1] += kept
    assert walks == sorted(walks, reverse=True)
    np.testing.assert_array_equal(seen, want)
    assert plan.blocks == plan.dkdv_blocks + plan.dq_blocks   # one grid


def test_plan_matches_the_kernel_source():
    """The plan's block rows and walked-tile widths are the kernel's."""
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    assert f"constexpr int kMmaRows = {ref.FLASH_BWD_ROWS};" in text
    wide, narrow = map(int, re.search(
        r"COLS = DP <= 96 \? (\d+) : (\d+);", text).groups())
    for d in (8, 32, 64, 72, 96):
        assert ref.flash_bwd_plan(1, 4, 2, 64, 64, d).cols == wide
    for d in (104, 128):
        assert ref.flash_bwd_plan(1, 4, 2, 64, 64, d).cols == narrow
    assert ref.flash_bwd_mma(128, 64) and not ref.flash_bwd_mma(136, 4)
    assert not ref.flash_bwd_mma(64, 65)


# (B, H, Hkv, Sq, Sk, D, causal): groups 1-64, lengths off the tile,
# more than one key tile, full attention with Sq != Sk, both walked-tile
# widths
SHAPES = [(2, 4, 2, 7, 7, 8, True), (1, 6, 3, 5, 9, 16, False),
          (1, 8, 2, 65, 65, 64, True), (1, 4, 1, 33, 33, 96, True),
          (1, 8, 1, 70, 70, 128, True), (1, 8, 4, 33, 65, 128, False),
          (1, 64, 1, 40, 40, 8, True), (2, 3, 3, 66, 66, 32, True)]


def _inputs(shape, seed):
    b, h, hkv, sq, sk, d, _ = shape
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    return mk(b, h, sq, d), mk(b, hkv, sk, d), mk(b, hkv, sk, d), \
        mk(b, h, sq, d)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_emulated_order_is_float64_autograd(shape):
    causal = shape[-1]
    q, k, v, do = _inputs(shape, seed=6)
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal)
    got = ref.flash_attention_bwd_emulated(q, k, v, out, lse, do, causal)
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    exact = torch.autograd.grad(
        ref.flash_attention_ref(*leaves, causal=causal), leaves, do.double())
    for g, x in zip(got, exact):
        assert g.shape == x.shape and g.dtype == torch.float32
        lim = F64_TOL * max(1.0, float(x.abs().max()))
        assert float((g.double() - x).abs().max()) <= lim


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_emulated_order_matches_jax(shape):
    """The emulation against ``jax.vjp`` of the reference's
    ``chunked_attention`` on the same inputs and cotangent, as
    ``tests/test_torch_flash_grad.py`` holds the plain backward."""
    causal = shape[-1]
    q, k, v, do = _inputs(shape, seed=7)
    _, vjp = jax.vjp(
        lambda a, b, c: JL.chunked_attention(a, b, c, causal=causal),
        *(jnp.asarray(t.transpose(1, 2).numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.transpose(1, 2).numpy()))
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal)
    got = ref.flash_attention_bwd_emulated(q, k, v, out, lse, do, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w),
                                   atol=JAX_TOL, rtol=JAX_TOL)
