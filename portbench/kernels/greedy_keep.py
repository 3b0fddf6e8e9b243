"""The NMS walk (`csrc/nms_mask.cu`, greedy_kernel): per problem, each
strip of 32 boxes that keeps a box reads its rows' words from its own
column on.  What these inputs need cannot be read without the keep set,
so the count is its floor: the first ceil(max_out / 32) strips, as when
the first max_out boxes are all kept."""

import math

from portbench.roofline import least_s


def cost(args) -> float:
    p, n, max_out = args[3], args[4], args[5]
    strips = min(math.ceil(max_out / 32), n // 32)
    return least_s(4.0 * p * sum(n - 32 * s for s in range(strips)), 0.0)
