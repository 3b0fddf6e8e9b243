"""tpudenoise_torch — the PyTorch/CUDA port of tpudenoise.

The JAX package `tpudenoise` stays the reference; this package mirrors its
module paths (`tpudenoise_torch.ops.nms` is the counterpart of
`tpudenoise.ops.nms`) and imports nothing of jax, flax or `tpudenoise`:
where it needs a jax-free piece of the reference (the noise grammar, the
blob geometry, the `.npz` reader) it keeps its own copy.

Every Pallas kernel on the ported path is a hand-written CUDA kernel under
`csrc/`, built with nvcc at first use (see `cuda_build`).  Each kernel's
wrapper runs its plain PyTorch version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

__version__ = "0.1.0"
