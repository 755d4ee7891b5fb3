"""PyTorch + CUDA port of the Mist reproduction, for NVIDIA Hopper (H100).

The package mirrors the layout of ``repro`` (the JAX reference) module by
module.  It imports ``torch``, numpy and the standard library only: never
``jax`` and never anything of ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; the hand-written Hopper kernels
live in ``repro_torch.kernels`` (see docs/port.md).
"""
