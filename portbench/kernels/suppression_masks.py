"""Kernel 3 (`csrc/nms_mask.cu`, mask_kernel): the IoU decision of each
pair i < j of N score-sorted boxes, ~15 operations a pair; the boxes
read once and the (N/32, N) words written once, per problem."""

from portbench.roofline import least_s


def cost(args) -> float:
    b, n = args[2], args[3]
    return least_s(16.0 * b * n + 4.0 * b * (n // 32) * n,
                   15.0 * b * n * (n - 1) / 2)
