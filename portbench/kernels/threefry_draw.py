"""The threefry kernel (`csrc/threefry.cu`): K keys x n words of the
threefry2x32 stream.  Per word: the block function 78 operations, a
uniform 4 more, a normal (erf_inv) 26 more; each output written once."""

from portbench.roofline import least_s

OPS = {0: 78, 1: 82, 2: 104}          # bits, uniform, normal


def cost(args) -> float:
    k, n, mode = args[2], args[3], args[4]
    return least_s(4.0 * k * n, OPS[mode] * k * n)
