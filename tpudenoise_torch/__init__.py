"""tpudenoise_torch — the PyTorch/CUDA port of tpudenoise.

The JAX package `tpudenoise` stays the reference; this package mirrors its
module paths (`tpudenoise_torch.ops.nms` is the counterpart of
`tpudenoise.ops.nms`) and never imports jax or flax.  Its only imports
from the JAX package are the jax-free modules `noise.spec`, `utils.blob`,
`models.convert.load_params_npz` and `eval.voc_eval`.

Every Pallas kernel on the ported path is a hand-written CUDA kernel under
`csrc/`, built with nvcc at first use (see `cuda_build`).  Each kernel's
wrapper runs its plain PyTorch version for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other.
"""

__version__ = "0.1.0"
