"""Kernel 5 (`csrc/bilateral.cu`): the d=9 bilateral, 312 operations an
element (the 49 taps' weights and sums); each input element read once
and each float32 output written once."""

from portbench.roofline import itemsize, least_s, numel


def cost(args) -> float:
    images = args[0]
    n = numel(images)
    return least_s(n * (itemsize(images) + 4), 312 * n)
