"""The port's config: every key of the JAX package's default config.

Values and types mirror `tpudenoise/core/config.py` key for key (the JAX
config itself is not imported: `tpudenoise.core` pulls in jax through
`core/mesh.py`, and its `config.py` imports yaml at the top).  The YAML
overlay (`cfg_from_file`) goes through `utils/cfg_reader.py`, a reader
of the subset of YAML the repo's cfg files use, since the GPU machine has
no yaml; the `KEY VALUE` overlay (`cfg_from_list`) and the type promotion
of the merge are the JAX package's, so both accept and refuse the same
keys.

Library code takes its config as an argument; the module-level `cfg`
exists for the CLIs, as in the JAX package.
"""

from __future__ import annotations

import os
import os.path as osp
from ast import literal_eval
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
    """The JAX package's defaults, key for key.  No code of the port reads
    TEST.SVM/BBOX_REG/HAS_RPN, MOBILENET.REGU_DEPTH/WEIGHT_DECAY (the JAX
    package reads them nowhere either: its step decays every kernel by
    TRAIN.WEIGHT_DECAY), USE_GPU_NMS/USE_E2E_TF, POOLING_MODE or TPU.*;
    they are here so that the cfg files and `--set` overlays apply as in
    the JAX package."""
    C = AttrDict()

    C.TRAIN = AttrDict()
    C.TRAIN.LEARNING_RATE = 0.001
    C.TRAIN.MOMENTUM = 0.9
    C.TRAIN.WEIGHT_DECAY = 0.0001
    C.TRAIN.GAMMA = 0.1
    C.TRAIN.STEPSIZE = [30000]
    C.TRAIN.WARMUP_ITERS = 0
    C.TRAIN.GRAD_CLIP = 0.0
    C.TRAIN.DISPLAY = 10
    C.TRAIN.DOUBLE_BIAS = True
    C.TRAIN.TRUNCATED = False
    C.TRAIN.BIAS_DECAY = False
    C.TRAIN.USE_GT = False
    C.TRAIN.ASPECT_GROUPING = False
    C.TRAIN.SNAPSHOT_KEPT = 3
    C.TRAIN.SUMMARY_INTERVAL = 180
    C.TRAIN.SCALES = (600,)
    C.TRAIN.MAX_SIZE = 1000
    C.TRAIN.IMS_PER_BATCH = 1
    C.TRAIN.BATCH_SIZE = 128
    C.TRAIN.FG_FRACTION = 0.25
    C.TRAIN.FG_THRESH = 0.5
    C.TRAIN.BG_THRESH_HI = 0.5
    C.TRAIN.BG_THRESH_LO = 0.1
    C.TRAIN.USE_FLIPPED = True
    C.TRAIN.BBOX_REG = True
    C.TRAIN.BBOX_THRESH = 0.5
    C.TRAIN.SNAPSHOT_ITERS = 5000
    C.TRAIN.SNAPSHOT_PREFIX = 'res101_faster_rcnn'
    C.TRAIN.BBOX_NORMALIZE_TARGETS = True
    C.TRAIN.BBOX_INSIDE_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    C.TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED = True
    C.TRAIN.BBOX_NORMALIZE_MEANS = (0.0, 0.0, 0.0, 0.0)
    C.TRAIN.BBOX_NORMALIZE_STDS = (0.1, 0.1, 0.2, 0.2)
    C.TRAIN.PROPOSAL_METHOD = 'gt'
    C.TRAIN.HAS_RPN = True
    C.TRAIN.RPN_POSITIVE_OVERLAP = 0.7
    C.TRAIN.RPN_NEGATIVE_OVERLAP = 0.3
    C.TRAIN.RPN_CLOBBER_POSITIVES = False
    C.TRAIN.RPN_FG_FRACTION = 0.5
    C.TRAIN.RPN_BATCHSIZE = 256
    C.TRAIN.RPN_NMS_THRESH = 0.7
    C.TRAIN.RPN_PRE_NMS_TOP_N = 12000
    C.TRAIN.RPN_POST_NMS_TOP_N = 2000
    C.TRAIN.RPN_BBOX_INSIDE_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    C.TRAIN.RPN_POSITIVE_WEIGHT = -1.0
    C.TRAIN.USE_ALL_GT = True

    C.TEST = AttrDict()
    C.TEST.SCALES = (600,)
    C.TEST.MAX_SIZE = 1000
    C.TEST.NMS = 0.3
    C.TEST.SVM = False
    C.TEST.BBOX_REG = True
    C.TEST.HAS_RPN = False
    C.TEST.PROPOSAL_METHOD = 'gt'
    C.TEST.RPN_NMS_THRESH = 0.7
    C.TEST.RPN_PRE_NMS_TOP_N = 6000
    C.TEST.RPN_POST_NMS_TOP_N = 300
    C.TEST.MODE = 'nms'
    C.TEST.RPN_TOP_N = 5000

    C.RESNET = AttrDict()
    C.RESNET.MAX_POOL = False      # False: a direct 7x7 crop, no max-pool
    C.RESNET.FIXED_BLOCKS = 1
    C.RESNET.FREEZE_ROOT = True

    C.MOBILENET = AttrDict()
    C.MOBILENET.REGU_DEPTH = False
    C.MOBILENET.FIXED_LAYERS = 5
    C.MOBILENET.WEIGHT_DECAY = 0.00004
    C.MOBILENET.DEPTH_MULTIPLIER = 1.

    # BGR order, as cv2.imread delivers images
    C.PIXEL_MEANS = np.array([[[102.9801, 115.9465, 122.7717]]])
    C.RNG_SEED = 3
    C.ROOT_DIR = osp.abspath(osp.join(osp.dirname(__file__), '..', '..'))
    C.DATA_DIR = osp.abspath(osp.join(C.ROOT_DIR, 'data'))
    C.MATLAB = 'matlab'
    C.EXP_DIR = 'default'
    C.USE_NATIVE_NMS = True
    C.USE_GPU_NMS = True
    C.USE_E2E_TF = True
    C.POOLING_MODE = 'crop'
    C.POOLING_SIZE = 7
    C.ANCHOR_SCALES = [8, 16, 32]
    C.ANCHOR_RATIOS = [0.5, 1, 2]
    C.RPN_CHANNELS = 512

    C.TPU = AttrDict()
    C.TPU.MESH_SHAPE = [-1]
    C.TPU.MESH_AXES = ['data']
    C.TPU.COMPUTE_DTYPE = 'bfloat16'
    C.TPU.PARAM_DTYPE = 'float32'
    C.TPU.IMAGE_BUCKETS = [[608, 1024]]
    C.TPU.MAX_GT_BOXES = 100
    return C


# for the CLIs; library code takes its config explicitly
cfg = default_config()


def _merge_a_into_b(a: dict, b: AttrDict) -> None:
    """Type-checked recursive merge, with the JAX package's promotions:
    ndarray from a list, tuple from a list, float from an int, int from an
    integral float."""
    if not isinstance(a, dict):
        raise TypeError(f'expected dict, got {type(a)}')
    for k, v in a.items():
        if k not in b:
            raise KeyError(f'{k} is not a valid config key')
        old = b[k]
        if isinstance(old, np.ndarray):
            v = np.array(v, dtype=old.dtype)
        elif isinstance(old, tuple) and isinstance(v, list):
            v = tuple(v)
        elif old is not None and v is not None \
                and not isinstance(v, type(old)) \
                and not (isinstance(old, dict) and isinstance(v, dict)):
            if isinstance(old, float) and isinstance(v, int):
                v = float(v)
            elif isinstance(old, int) and isinstance(v, float) and v == int(v):
                v = int(v)
            else:
                raise ValueError(
                    f'type mismatch ({type(old)} vs {type(v)}) for key {k}')
        if isinstance(old, dict):
            _merge_a_into_b(v, b[k])
        else:
            b[k] = v


def cfg_from_file(filename: str, into: AttrDict | None = None) -> AttrDict:
    """Merge a cfg file (the YAML subset of `utils/cfg_reader.py`) into a
    config: `into`, else the module-level `cfg`."""
    from tpudenoise_torch.utils.cfg_reader import load
    target = cfg if into is None else into
    overlay = load(filename)
    if overlay:
        _merge_a_into_b(overlay, target)
    return target


def _require(ok: bool, message: str) -> None:
    # AssertionError, as the JAX package's asserts raise, also under -O
    if not ok:
        raise AssertionError(message)


def cfg_from_list(cfg_list: list, into: AttrDict | None = None) -> AttrDict:
    """Set config keys from ['KEY', 'VALUE', ...] pairs: each VALUE through
    `ast.literal_eval`, else kept as the string."""
    target = cfg if into is None else into
    _require(len(cfg_list) % 2 == 0, 'cfg_from_list takes KEY VALUE pairs')
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = full_key.split('.')
        d = target
        for subkey in key_list[:-1]:
            _require(subkey in d, f'{full_key} is not a valid config key')
            d = d[subkey]
        subkey = key_list[-1]
        _require(subkey in d, f'{full_key} is not a valid config key')
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        old = d[subkey]
        if isinstance(old, np.ndarray):
            value = np.array(value, dtype=old.dtype)
        elif isinstance(old, tuple):
            value = tuple(value)
        elif isinstance(old, float) and isinstance(value, int):
            value = float(value)
        elif old is not None and value is not None \
                and not isinstance(value, type(old)):
            raise ValueError(
                f'type mismatch ({type(old)} vs {type(value)}) '
                f'for key {full_key}')
        d[subkey] = value
    return target


def _artifact_dir(kind: str, imdb_name: str, weights_filename: str | None,
                  config: AttrDict | None) -> str:
    C = config or cfg
    outdir = osp.abspath(osp.join(C.ROOT_DIR, kind, C.EXP_DIR, imdb_name,
                                  weights_filename or 'default'))
    os.makedirs(outdir, exist_ok=True)
    return outdir


def get_output_dir(imdb_name: str, weights_filename: str | None,
                   config: AttrDict | None = None) -> str:
    """Artifact directory `ROOT_DIR/output/EXP_DIR/imdb/weights`."""
    return _artifact_dir('output', imdb_name, weights_filename, config)


def get_output_tb_dir(imdb_name: str, weights_filename: str | None,
                      config: AttrDict | None = None) -> str:
    """Log directory `ROOT_DIR/tensorboard/EXP_DIR/imdb/weights`."""
    return _artifact_dir('tensorboard', imdb_name, weights_filename, config)
