"""The port's default config: only the keys the port reads.

Values mirror `tpudenoise/core/config.py` key for key (the JAX config
itself is not imported: `tpudenoise.core` pulls in jax through
`core/mesh.py`, and `config.py` imports yaml at the top).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any

import numpy as np


class AttrDict(dict):
    """dict with attribute access; recursive over nested dicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


def default_config() -> AttrDict:
    C = AttrDict()

    C.TRAIN = AttrDict()
    C.TRAIN.BBOX_NORMALIZE_MEANS = (0.0, 0.0, 0.0, 0.0)
    C.TRAIN.BBOX_NORMALIZE_STDS = (0.1, 0.1, 0.2, 0.2)

    C.TEST = AttrDict()
    C.TEST.SCALES = (600,)
    C.TEST.MAX_SIZE = 1000
    C.TEST.NMS = 0.3
    C.TEST.RPN_NMS_THRESH = 0.7
    C.TEST.RPN_PRE_NMS_TOP_N = 6000
    C.TEST.RPN_POST_NMS_TOP_N = 300
    C.TEST.MODE = 'nms'
    C.TEST.RPN_TOP_N = 5000

    # BGR order, as cv2.imread delivers images
    C.PIXEL_MEANS = np.array([[[102.9801, 115.9465, 122.7717]]])
    C.RNG_SEED = 3
    C.ROOT_DIR = osp.abspath(osp.join(osp.dirname(__file__), '..', '..'))
    C.DATA_DIR = osp.abspath(osp.join(C.ROOT_DIR, 'data'))
    C.EXP_DIR = 'default'
    C.POOLING_SIZE = 7
    C.ANCHOR_SCALES = [8, 16, 32]
    C.ANCHOR_RATIOS = [0.5, 1, 2]
    C.RPN_CHANNELS = 512

    C.RESNET = AttrDict()
    C.RESNET.MAX_POOL = False      # False: a direct 7x7 crop, no max-pool
    return C


def get_output_dir(imdb_name: str, weights_filename: str | None,
                   config: AttrDict | None = None) -> str:
    """Artifact directory `ROOT_DIR/output/EXP_DIR/imdb/weights`."""
    C = config or default_config()
    outdir = osp.abspath(osp.join(C.ROOT_DIR, 'output', C.EXP_DIR, imdb_name,
                                  weights_filename or 'default'))
    os.makedirs(outdir, exist_ok=True)
    return outdir
