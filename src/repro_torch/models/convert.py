"""Param conversion between the JAX package's pytree and the port.

Both sides use the same nested-dict layout (stacked layers, ``[d_in,
d_out]`` weights), so conversion is leaf by leaf, whatever the tree
holds: the transformer's ``attn``/``mlp`` blocks and tied embedding, or
RWKV6's stacked ``time_mix``/``channel_mix`` blocks, its ``ln0`` and its
untied ``lm_head``.  The JAX side hands over plain ``np.ndarray`` leaves
(``jax.device_get`` on its params), so this module needs neither JAX
nor the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cuda"):
    """Nested dict of ``np.ndarray`` -> the same dict of tensors on
    ``device`` (dtype kept)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    # copy: arrays handed over by JAX are read-only
    return torch.from_numpy(np.array(tree, order="C")).to(device)


def params_to_numpy(tree):
    """Inverse of :func:`params_from_jax`: tensors -> ``np.ndarray``."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
