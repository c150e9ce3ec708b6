"""PyTorch + CUDA port of ``tpu_stark`` for NVIDIA Hopper (H100).

Same sub-package layout and function names as ``tpu_stark``; the JAX
package is the reference every module here is tested against, bit for bit.

Conventions shared by every module:

* Field elements are ``torch.int32`` tensors holding the same Montgomery
  values as the JAX package's ``uint32`` arrays (every BabyBear value is
  below 2^31, so the bits are identical).  Plain arithmetic widens to
  ``int64``.
* Every function takes or derives an explicit ``device``; there are no
  global device knobs.
* The hand-written CUDA kernels (``csrc/``) are built with ``nvcc`` at first
  use into ``tpu_stark_torch/build/`` (``kernels.py``).  Each kernel wrapper
  runs the plain torch version only for CPU tensors; for a CUDA tensor it
  launches the kernel or raises.

This package imports ``torch`` and never ``jax``.
"""
