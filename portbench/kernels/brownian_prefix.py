"""The brownian pre-pass of kernel 6 (`csrc/mix_noise.cu`,
brownian_rows_kernel and brownian_offsets_kernel): for each image drawn
brownian, per element a counter-hash normal (35 operations) and its
row's log-step scan (log2 of the row's length in adds), the row written
once as float32; the other images do nothing."""

import math

from portbench.roofline import least_s


def cost(args) -> float:
    kind, b, h, w3 = args[0], args[6], args[7], args[8]
    if kind[3] is None:
        return None
    n = sum(int(k) == 7 for k in kind[3].cpu().tolist()) * h * w3
    return least_s(4.0 * n, (35 + math.ceil(math.log2(w3))) * n)
