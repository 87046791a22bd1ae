"""fasim_tpu_torch — the fastSIM triplex scanner on PyTorch and CUDA.

A port of `fasim_tpu` (JAX/Pallas on a TPU) to one NVIDIA Hopper GPU.
The device passes run as hand-written CUDA kernels built from `csrc/` at
first use; each has a plain PyTorch version beside it, which the wrappers
take for CPU tensors.  The host stages (FASTA reading, rule tables, the
native C++ candidate stage and exact SIM, clustering and output) are this
package's own copies of `fasim_tpu`'s modules, under the same module
paths; `fasim_tpu` stays the reference this package is held against.

Layering (top to bottom): cli -> scan.batched (batched driver) or
scan.pipeline (per-segment path) -> kernels.engine -> {kernels.scan,
kernels.scan_codes, kernels.window, kernels.pack} -> csrc/*.cu; host
stages in scan.candidates, native, post.output.  This package imports
neither `jax` nor `fasim_tpu`.
"""

__version__ = "0.1.0"
