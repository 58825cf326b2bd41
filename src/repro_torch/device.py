"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``cuda`` is the default everywhere; asking for it on a machine
    without a usable card raises instead of carrying on on the CPU.
    The port's numerical contract is full f32, so TF32 is switched off
    for matrix products and cuDNN here, explicitly.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' (launcher: --device cpu) to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
