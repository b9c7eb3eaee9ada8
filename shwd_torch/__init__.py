"""shwd_torch: the Sphere-Homeomorphic Wasserstein Distance in PyTorch.

Port of the JAX package ``shwd_tpu`` for NVIDIA Hopper cards. Module and
public function names follow the JAX package so each counterpart is easy to
find; inside, the code is PyTorch: phi is an ``nn.Module`` tree, ops are
plain functions on tensors, devices and random generators are explicit.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. The
hand-written CUDA kernels (``csrc/``) are built with ``nvcc`` at first use
into ``_build/``; on a CPU tensor each kernel wrapper runs its plain
PyTorch version instead.

This package never imports JAX.
"""

from .device import resolve_device  # noqa: F401
