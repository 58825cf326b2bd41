"""The port's training kernels on the card: run there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

Imports torch only (the machine with the card has no JAX); every test
is marked ``cuda`` and skips without a card."""
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
