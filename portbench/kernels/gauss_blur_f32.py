"""Kernel 2 (`csrc/fused_noise.cu`, gauss_blur on float32 frames): Box-Muller
noise from two coordinate hashes, then one or two [1,2,1] blurs.  Per
element: two hashes 30, Box-Muller 12, the clip and cast 6, each blur
pass 12 operations; each element read once and written once."""

from portbench.roofline import itemsize, least_s, numel


def cost(args) -> float:
    images, noisy, double = args[0], args[7], args[8]
    n = numel(images)
    ops = (2 * 15 + 12 + 6 if noisy else 0) + 12 * (2 if double else 1)
    return least_s(n * 2 * itemsize(images), ops * n)
