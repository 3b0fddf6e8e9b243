"""Kernel 6 (`csrc/mix_noise.cu`, mix_noise): each image its drawn
kind's generator.  Operations per element by Kind value, counted from
the plain version (`chip_smoke.py`'s MIX_OPS); the u8 frames read once,
the float32 output written once."""

from portbench.roofline import least_s, numel

MIX_OPS = {0: 0, 1: 45, 2: 330, 3: 20, 4: 47, 5: 110, 6: 22, 7: 60, 8: 8,
           9: 300, 10: 25, 11: 430, 12: 6}


def cost(args) -> float:
    images, kind = args[0], args[2]
    if kind[3] is None:
        return None
    b = images[1][0]
    per_image = numel(images) // b
    ops = sum(MIX_OPS[int(k)] for k in kind[3].cpu().tolist()) * per_image
    return least_s(5 * numel(images), ops)
