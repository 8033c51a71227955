"""PyTorch/CUDA port of the HPU serving system.

A second package beside ``repro`` (the JAX/TPU reference).  It imports
``torch`` and numpy only — never ``jax`` and nothing of ``repro`` — and
keeps its own copies of what it needs.  Decode and prefill attention run
through hand-written CUDA kernels for Hopper (``repro_torch.kernels``);
every kernel has a plain PyTorch version beside it that the CPU path
uses.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
