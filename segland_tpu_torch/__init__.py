"""segland_tpu_torch -- the PyTorch / CUDA port of segland_tpu for NVIDIA
H100 GPUs.

It sits beside the JAX package, which stays the reference it is tested
against, and keeps that package's module paths so each counterpart is
found by name.  Modules are NCHW ``nn.Module``s with upstream SegLand's
parameter names; public ops keep the JAX layout.  The TPU's Pallas kernels
on a ported path are hand-written CUDA C++ under ``kernels/csrc``, built by
``nvcc`` at the first CUDA call; on the CPU every op runs its plain PyTorch
version.  Importing the package needs neither jax nor nvcc.
"""

__version__ = "0.1.0"
