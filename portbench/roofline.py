"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at
the 700 W limit) and the least time of a piece of work."""

HBM_BYTES_PER_S = 3.35e12      # device memory
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # bf16 tensor cores, dense


def least_s(nbytes: float, ops: float) -> float:
    """The larger of bytes over the memory rate and operations over the
    non-tensor float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def numel(summary) -> int:
    """Elements of a launch argument kept as a tensor summary ('tensor',
    shape, dtype, table or None)."""
    n = 1
    for d in summary[1]:
        n *= d
    return n


def itemsize(summary) -> int:
    return {'torch.uint8': 1, 'torch.int32': 4, 'torch.float32': 4,
            'torch.bool': 1, 'torch.int64': 8}[summary[2]]
