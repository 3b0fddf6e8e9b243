"""Kernel 1 (`csrc/fused_noise.cu`, sap_median on u8 frames): salt and
pepper by the coordinate hash, then one or two 3x3 medians.  Per
element: the hash 15, compare and select 4, each median pass 16
operations; each element read once and written once."""

from portbench.roofline import itemsize, least_s, numel


def cost(args) -> float:
    images, double = args[0], args[7]
    n = numel(images)
    ops = 15 + 4 + 16 * (2 if double else 1)
    return least_s(n * 2 * itemsize(images), ops * n)
