"""Relayout MCG proposal .mat files into the nested directory scheme a
COCO proposal loader expects (counterpart of `tpudenoise/data/
mcg_munge.py`, ref lib/datasets/tools/mcg_munge.py).

Downloaded MCG boxes arrive flat:
    MCG-COCO-val2014-boxes/COCO_val2014_000000193401.mat
The loader wants them nested by the first 14 / first 22 characters:
    MCG/mat/COCO_val2014_0/COCO_val2014_000000193/COCO_val2014_000000193401.mat

    python -m tpudenoise_torch.data.mcg_munge SRC_DIR

NB (reference doc): MCG-website boxes are (y1, x1, y2, x2); Hosang et
al.'s are (x1, y1, x2, y2).
"""

from __future__ import annotations

import os
import sys


def munge(src_dir: str, dst_root: str = 'MCG') -> int:
    """Move every file in `src_dir` into dst_root/mat/<first14>/<first22>/.
    Returns the number of files moved."""
    moved = 0
    for fn in sorted(os.listdir(src_dir)):
        base, _ = os.path.splitext(fn)
        dst_dir = os.path.join(dst_root, 'mat', base[:14], base[:22])
        os.makedirs(dst_dir, exist_ok=True)
        src = os.path.join(src_dir, fn)
        dst = os.path.join(dst_dir, fn)
        print(f'MV: {src} -> {dst}')
        os.rename(src, dst)
        moved += 1
    return moved


if __name__ == '__main__':
    munge(sys.argv[1])
