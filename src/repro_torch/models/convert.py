"""Param conversion between the JAX package's pytree and the port.

Both sides use the same nested-dict layout (stacked layers, ``[d_in,
d_out]`` weights), so conversion is leaf by leaf, whatever the tree
holds: the transformer's ``attn``/``mlp`` blocks and tied embedding
(an MoE ``mlp``: the ``router`` and ``w_gate``/``w_up``/``w_down`` as
[L, E, d, f]), RWKV6's stacked ``time_mix``/``channel_mix`` blocks, its
``ln0`` and its untied ``lm_head``, or Zamba2's ``shared_attn``, stacked
``layers.mamba`` and ``lm_head``; the AdamW state converts the same way
(:func:`opt_state_from_jax`).  The JAX side hands over plain
``np.ndarray`` leaves (``jax.device_get`` on its params), so this module
needs neither JAX nor the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState


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


def opt_state_from_jax(state, device="cuda"):
    """The JAX package's ``AdamWState(step, m, v)`` with ``np.ndarray``
    leaves (``jax.device_get``) -> the port's ``AdamWState`` of tensors
    on ``device`` (``step`` a 0-d int32 tensor)."""
    step, m, v = state
    return AdamWState(step=params_from_jax(np.asarray(step, np.int32),
                                           device),
                      m=params_from_jax(m, device),
                      v=params_from_jax(v, device))


def opt_state_to_numpy(state):
    """Inverse of :func:`opt_state_from_jax`: (step, m, v) of
    ``np.ndarray``, for ``AdamWState(*...)`` on the JAX side."""
    return tuple(params_to_numpy(x) for x in state)
