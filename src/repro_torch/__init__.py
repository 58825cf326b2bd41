"""PyTorch + CUDA port of the DockerSSD reproduction (``repro``).

The JAX package ``repro`` is the reference; this package imports
nothing of it and nothing of JAX.  Entry points run on ``cuda`` unless
the caller asks for the CPU, and raise when CUDA is asked for and
absent (:func:`repro_torch.device.resolve_device`).
"""
