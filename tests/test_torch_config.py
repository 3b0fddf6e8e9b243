"""The port's config holds the keys the eval slice reads, each equal to the
JAX package's default."""

import numpy as np
import pytest

from tpudenoise.core.config import default_config as jax_default_config
from tpudenoise_torch.core.config import default_config, get_output_dir

KEYS = ['TEST.SCALES', 'TEST.MAX_SIZE', 'TEST.NMS', 'TEST.RPN_NMS_THRESH',
        'TEST.RPN_PRE_NMS_TOP_N', 'TEST.RPN_POST_NMS_TOP_N', 'TEST.MODE',
        'TEST.RPN_TOP_N', 'TRAIN.BBOX_NORMALIZE_MEANS',
        'TRAIN.BBOX_NORMALIZE_STDS', 'PIXEL_MEANS', 'RNG_SEED',
        'POOLING_SIZE', 'ANCHOR_SCALES', 'ANCHOR_RATIOS', 'RPN_CHANNELS',
        'ROOT_DIR', 'EXP_DIR']


def _get(cfg, dotted):
    for part in dotted.split('.'):
        cfg = cfg[part]
    return cfg


@pytest.mark.parametrize('key', KEYS)
def test_key_equals_jax_default(key):
    got, want = _get(default_config(), key), _get(jax_default_config(), key)
    assert type(got) is type(want), (key, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_output_dir_layout(tmp_path):
    from tpudenoise.core.config import get_output_dir as jax_get_output_dir
    a, b = default_config(), jax_default_config()
    a.ROOT_DIR = b.ROOT_DIR = str(tmp_path)
    assert get_output_dir('voc', 'w', a) == jax_get_output_dir('voc', 'w', b)
