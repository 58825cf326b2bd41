"""The flash kernel's 3xTF32 arithmetic emulated on the CPU: the torch
emulation of ``cvt.rna.tf32.f32`` (``ref.tf32_rna``) against an
independent rounding of each value, the 3xTF32 product
(``ref.mm_3xtf32``) against float64, and the emulated kernel
(``ref.flash_attention_3xtf32``: its key tiles, base-2 online softmax and
3xTF32 products) within 1e-5 of the plain version and of the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs.
Also: the wrapper's ``kernel_takes`` holds for the attention shape of
every configuration of the port."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402

# f32 products on both sides (3xTF32 drops ~2^-22 relative); the sums,
# the exp2 and the tiles' order differ
FLASH_TOL = 1e-5


def _tf32_exact(x: float) -> float:
    """Round x to 11 significant bits (below 2^-126 to the subnormal grid
    of 2^-136), ties away from zero, in exact arithmetic (independent of
    the bit trick under test)."""
    if x == 0.0:
        return x
    _, e = math.frexp(abs(x))            # |x| = m 2^e, m in [0.5, 1)
    step = 2.0 ** max(e - 11, -136)
    r = math.floor(abs(x) / step + 0.5)  # ties go up: away from zero
    return math.copysign(r * step, x)


@pytest.mark.parametrize("values", [
    [1 + 2 ** -11, 1 + 2 ** -12, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
     2 - 2 ** -11, 2 - 2 ** -12, 3.0, -0.0, 2 ** -130, -(2 ** -140) * 3,
     65504.0, 1e30, -1e-30],
    "random",
])
def test_tf32_rna_rounds_to_nearest_ties_away(values):
    if values == "random":
        rng = np.random.default_rng(0)
        values = (rng.standard_normal(4096) *
                  10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32)
    x = torch.tensor(np.asarray(values, np.float32))
    got = tref.tf32_rna(x).numpy()
    want = np.array([_tf32_exact(float(v)) for v in x.numpy()], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("d", [32, 64, 80, 96, 128])
def test_3xtf32_product_keeps_f32_precision(d):
    rng = np.random.default_rng(d)
    a = rng.standard_normal((64, d), dtype=np.float32)
    b = rng.standard_normal((d, 48), dtype=np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    err3 = np.abs(tref.mm_3xtf32(ta, tb).numpy() - exact).max()
    err32 = np.abs((ta @ tb).numpy() - exact).max()
    err1 = np.abs((tref.tf32_rna(ta) @ tref.tf32_rna(tb)).numpy() -
                  exact).max()
    assert err3 <= 2 * err32 + 1e-6       # f32 precision
    assert err1 > 100 * err3              # one TF32 product is not


def _qkv(seed, b, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d), dtype=np.float32),
            rng.standard_normal((b, hkv, s, d), dtype=np.float32),
            rng.standard_normal((b, hkv, s, d), dtype=np.float32))


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 80, 96, 128])
def test_emulated_3xtf32_flash_matches_plain_and_pallas(d, causal, group):
    hkv, s = 2, 64
    q, k, v = _qkv(d + group, 1, group * hkv, hkv, s, d)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tref.flash_attention_3xtf32(tq, tk, tv, causal,
                                      block_k=tflash.KEY_TILE).numpy()
    plain = tref.flash_attention_ref(tq, tk, tv, causal=causal).numpy()
    pallas = np.asarray(jops.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, interpret=True))
    for want in (plain, pallas):
        np.testing.assert_allclose(got, want, atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_kernel_takes_every_configs_attention(arch):
    """Every configuration's head_dim and GQA group (phi3-mini-3.8b's
    head_dim is 96, paligemma-3b's 256, llama4-scout's group 5); the
    port's get_model builds every one of them (MoE archs too), so each
    reaches the kernel on every prefill."""
    cfg = get_arch(arch)
    assert tflash.kernel_takes(cfg.hd, cfg.n_heads // cfg.n_kv_heads)
    assert get_model(cfg).cfg is cfg


@pytest.mark.parametrize("d,group,takes", [
    (8, 1, True), (96, 1, True), (80, 16, True), (256, 64, True),
    (12, 1, False), (264, 1, False), (0, 1, False), (64, 65, False),
    (64, 0, False),
])
def test_kernel_takes_bounds(d, group, takes):
    assert tflash.kernel_takes(d, group) is takes
