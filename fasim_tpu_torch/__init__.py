"""fasim_tpu_torch — the fastSIM triplex scanner on PyTorch and CUDA.

A port of `fasim_tpu` (JAX/Pallas on a TPU) to one NVIDIA Hopper GPU.
The device passes of the default fastSIM path run as hand-written CUDA
kernels built from `csrc/` at first use; each has a plain PyTorch
version beside it, which the wrappers take for CPU tensors.  The host
stages (FASTA reading, rule tables, the native C++ candidate stage,
clustering and output) are imported unchanged from `fasim_tpu`, which
stays the reference this package is held against.

Layering (top to bottom): cli -> scan.batched -> kernels.engine ->
{kernels.scan, kernels.window, kernels.pack} -> csrc/*.cu.
This package never imports `jax`.
"""

__version__ = "0.1.0"
