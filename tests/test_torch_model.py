"""The port's TransformerLM against the JAX package's on converted
weights: param conversion round trip and full-forward logits."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro_torch.configs.base import ArchConfig, get_arch  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import (params_from_jax,  # noqa: E402
                                        params_to_numpy)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _jax_model(arch="granite_3_2b", **over):
    cfg = dataclasses.replace(jget_arch(arch).reduced(), n_layers=2,
                              vocab_size=64, **over)
    model = jget_model(cfg, compute_dtype=jnp.float32, moe_no_drop=True)
    return cfg, model, jax.device_get(model.init(jax.random.PRNGKey(0)))


def _port_cfg(jcfg):
    return ArchConfig(**dataclasses.asdict(jcfg))


def test_configs_match_the_jax_registry():
    for arch in ("granite_3_2b", "qwen2_72b", "zamba2_1_2b"):
        ours = dataclasses.asdict(get_arch(arch))
        assert ours == dataclasses.asdict(jget_arch(arch))
        assert (dataclasses.asdict(get_arch(arch).reduced()) ==
                dataclasses.asdict(jget_arch(arch).reduced()))


def test_params_from_jax_round_trip():
    _, _, jparams = _jax_model()
    tparams = params_from_jax(jparams, device="cpu")
    back = params_to_numpy(tparams)
    got, want = list(_leaves(back)), list(_leaves(jparams))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_init_has_the_jax_layout():
    cfg, _, jparams = _jax_model()
    gen = torch.Generator().manual_seed(0)
    tparams = get_model(_port_cfg(cfg)).init(gen, device="cpu")
    got = {p: tuple(t.shape) for p, t in _leaves(tparams)}
    want = {p: a.shape for p, a in _leaves(jparams)}
    assert got == want
    # truncated-normal fan-in init: |w| <= 2 / sqrt(fan_in)
    wq = tparams["layers"]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-7


@pytest.mark.parametrize("arch,over", [
    ("granite_3_2b", {}),
    ("qwen2_72b", {}),                                   # qkv bias, untied
    ("granite_3_2b", {"act": "gelu", "norm": "layernorm"}),
])
def test_forward_matches_jax(arch, over):
    cfg, jmodel, jparams = _jax_model(arch, **over)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 11),
                                               dtype=np.int32)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    model = get_model(_port_cfg(cfg))
    got, _ = model.forward(params_from_jax(jparams, device="cpu"),
                           {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_other_block_types_are_not_ported_yet():
    """Every block type is ported: the zamba2 hybrid builds a
    ``Zamba2LM``."""
    from repro_torch.models.mamba2 import Zamba2LM
    model = get_model(get_arch("zamba2_1_2b"))
    assert isinstance(model.impl, Zamba2LM) and model.n_attn == 7
