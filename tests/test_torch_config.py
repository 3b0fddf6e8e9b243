"""The port's config holds every key of the JAX package's default config,
each equal to its JAX default; its yaml-free cfg reader reads the repo's
cfg files as `yaml.safe_load` does and refuses what lies outside its
subset; `cfg_from_file` and `cfg_from_list` accept and refuse what the
JAX package's do; `save_params_npz` and `merge_pretrained` agree with
the JAX package's layout and counts."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import contextlib
import glob
import io
import os.path as osp

import numpy as np
import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from tpudenoise.core.config import default_config as jax_default_config
from tpudenoise_torch.core.config import default_config, get_output_dir

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CFG_FILES = sorted(glob.glob(osp.join(REPO, 'experiments', 'cfgs', '*.yml')))


def _leaves(cfg, prefix=''):
    for k, v in cfg.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + '.')
        else:
            yield prefix + k


KEYS = list(_leaves(jax_default_config()))


def _get(cfg, dotted):
    for part in dotted.split('.'):
        cfg = cfg[part]
    return cfg


def _assert_same(got, want, key):
    assert type(got) is type(want), (key, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want, (key, got, want)


def test_every_jax_key_is_there():
    assert len(KEYS) == 85
    assert sorted(_leaves(default_config())) == sorted(KEYS)


@pytest.mark.parametrize('key', KEYS)
def test_key_equals_jax_default(key):
    _assert_same(_get(default_config(), key), _get(jax_default_config(), key),
                 key)


def test_output_dir_layout(tmp_path):
    from tpudenoise.core.config import get_output_dir as jax_get_output_dir
    a, b = default_config(), jax_default_config()
    a.ROOT_DIR = b.ROOT_DIR = str(tmp_path)
    assert get_output_dir('voc', 'w', a) == jax_get_output_dir('voc', 'w', b)


def test_output_tb_dir_layout(tmp_path):
    from tpudenoise.core.config import get_output_tb_dir as jax_tb_dir
    from tpudenoise_torch.core.config import get_output_tb_dir
    a, b = default_config(), jax_default_config()
    a.ROOT_DIR = b.ROOT_DIR = str(tmp_path)
    a.EXP_DIR = b.EXP_DIR = 'res101'
    assert get_output_tb_dir('rr', None, a) == jax_tb_dir('rr', None, b)


# ---- the cfg reader ----

@pytest.mark.parametrize('path', CFG_FILES, ids=osp.basename)
def test_reader_equals_yaml(path):
    from tpudenoise_torch.utils.cfg_reader import load
    with open(path) as f:
        want = yaml.safe_load(f)
    assert load(path) == want


SCALARS = (st.integers(-10**12, 10**12)
           | st.floats(allow_nan=False, width=64)
           | st.booleans() | st.none()
           | st.from_regex(r'[a-z][a-z0-9_]{0,11}', fullmatch=True))
KEY = st.from_regex(r'[A-Z]{1,6}_[A-Z0-9]{0,5}', fullmatch=True)
VALUES = SCALARS | st.lists(SCALARS, max_size=3)


def _block(values):
    """Mappings that hold a flow list besides their other values:
    safe_dump(default_flow_style=None) writes a mapping of scalars alone
    as a flow mapping, which the reader refuses."""
    return st.builds(lambda d, lst: dict(d, LIST_0=lst),
                     st.dictionaries(KEY, values, max_size=4),
                     st.lists(SCALARS, max_size=3))


MAPPINGS = st.recursive(_block(VALUES), lambda inner: _block(VALUES | inner),
                        max_leaves=12)


@settings(max_examples=150, deadline=None)
@given(MAPPINGS)
def test_reader_reads_safe_dump(mapping):
    """Block mappings of the supported scalars and flow lists, as
    yaml.safe_dump writes them, read back equal."""
    from tpudenoise_torch.utils.cfg_reader import loads
    text = yaml.safe_dump(mapping, default_flow_style=None)
    assert yaml.safe_load(text) == mapping
    assert loads(text) == mapping, text


@pytest.mark.parametrize('text, line', [
    ('A: &x 1\nB: *x', 1),               # anchor
    ('A: !!str 3', 1),                   # tag
    ('A:\n  - 1\n  - 2', 2),             # block list
    ('A: |\n  text', 1),                 # block scalar
    ('A: one\n  two', 2),                # multi-line plain scalar
    ('A: {B: 1}', 1),                    # flow mapping
    ('{A: 1}', 1),
    ('A: [1,\n  2]', 1),                 # flow list over two lines
    ('A:\n\tB: 1', 2),                   # tab
    ('A: 1\nA: 2', 2),                   # duplicate key
    ('A: 1e-3', 1),                      # str in YAML 1.1, float in 1.2
    ('A: None', 1),                      # a string under YAML, None in Python
    ('A: yes', 1),                       # a bool under YAML 1.1 only
    ('A: 0x10', 1), ('A: 007', 1), ('A: 1_000', 1), ('A: 2021-01-01', 1),
    ('---\nA: 1', 1),                    # document marker
    ('A:\n    B: 1\n  C: 2', 3),         # indentation between levels
    ('- 1', 1),                          # a document that is no mapping
])
def test_reader_refuses_what_it_does_not_read(text, line, tmp_path):
    from tpudenoise_torch.utils.cfg_reader import load
    path = tmp_path / 'bad.yml'
    path.write_text(text)
    with pytest.raises(ValueError, match=rf'bad\.yml:{line}:'):
        load(str(path))


# ---- the overlays ----

@pytest.mark.parametrize('path', CFG_FILES, ids=osp.basename)
def test_cfg_from_file_equals_jax(path):
    from tpudenoise.core.config import cfg_from_file as jax_cfg_from_file
    from tpudenoise_torch.core.config import cfg_from_file
    got = cfg_from_file(path, into=default_config())
    want = jax_cfg_from_file(path, into=jax_default_config())
    for key in KEYS:
        _assert_same(_get(got, key), _get(want, key), key)


LISTS = [
    ['EXP_DIR', 'res101'],                     # a string stays a string
    ['TEST.SCALES', '[120]'],                  # a tuple from a list
    ['TEST.SCALES', '(800, 600)'],
    ['TEST.NMS', '1'],                         # a float from an int
    ['RNG_SEED', '7', 'TEST.MODE', 'top'],
    ['PIXEL_MEANS', '[[[1, 2, 3]]]'],          # an ndarray from a list
    ['ANCHOR_SCALES', '[2, 4, 8, 16, 32]'],
    ['TPU.IMAGE_BUCKETS', '[[800, 1344]]'],
    ['RESNET.MAX_POOL', 'True'],
    ['RNG_SEED', 'True'],                      # bool is an int: accepted
    ['NOPE', '1'],                             # unknown key
    ['TEST.NOPE', '1'],
    ['NOPE.SCALES', '1'],
    ['TEST'],                                  # not KEY VALUE pairs
    ['RNG_SEED', '1.5'],                       # type mismatches
    ['TEST.NMS', 'abc'],
    ['EXP_DIR', '5'],
    ['RESNET.MAX_POOL', '1'],
    ['TEST', '5'],
    ['TEST.SCALES', '600'],                    # tuple(600): TypeError
    ['PIXEL_MEANS', 'abc'],
]


@pytest.mark.parametrize('pairs', LISTS, ids=' '.join)
def test_cfg_from_list_like_jax(pairs):
    """The same result, or the same type of exception."""
    from tpudenoise.core.config import cfg_from_list as jax_cfg_from_list
    from tpudenoise_torch.core.config import cfg_from_list

    def run(fn, cfg):
        try:
            return fn(list(pairs), into=cfg), None
        except Exception as e:       # the type is compared below
            return None, type(e)

    got, got_err = run(cfg_from_list, default_config())
    want, want_err = run(jax_cfg_from_list, jax_default_config())
    assert got_err is want_err
    if want is not None:
        for key in KEYS:
            _assert_same(_get(got, key), _get(want, key), key)


@pytest.mark.parametrize('overlay', [
    'NOPE: 1', 'TEST:\n  NOPE: 1', 'RNG_SEED: 1.5', 'TEST:\n  NMS: x',
    'EXP_DIR:\n  A: 1', 'TEST: 3', 'TEST: [1]', 'PIXEL_MEANS: [[[1, 2, 3]]]',
    'RNG_SEED: 2.0\nTEST:\n  NMS: 1\n  SCALES: [500]\n  MODE: top',
])
def test_merge_like_jax(overlay, tmp_path):
    """cfg_from_file's merge: the same promotions and refusals."""
    from tpudenoise.core.config import cfg_from_file as jax_cfg_from_file
    from tpudenoise_torch.core.config import cfg_from_file
    path = tmp_path / 'o.yml'
    path.write_text(overlay)
    results = []
    for fn, cfg in ((cfg_from_file, default_config()),
                    (jax_cfg_from_file, jax_default_config())):
        try:
            results.append((fn(str(path), into=cfg), None))
        except Exception as e:       # the type is compared below
            results.append((None, type(e)))
    (got, got_err), (want, want_err) = results
    assert got_err is want_err
    if want is not None:
        for key in KEYS:
            _assert_same(_get(got, key), _get(want, key), key)


# ---- weights ----

@pytest.fixture(scope='module')
def port_inits():
    """The port's seeded res50 init (vgg16's takes ~10 s on the CPU; the
    CLI tests merge a whole vgg16 .npz)."""
    import torch
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    return {'res50': FasterRCNN('res50', num_classes=2,
                                dtype=torch.float32).init(
        torch.Generator().manual_seed(0))}


@pytest.fixture(scope='module')
def jax_trees():
    import jax
    import jax.numpy as jnp
    from tpudenoise.models.faster_rcnn import FasterRCNN as JRCNN
    out = {}
    for net in ('vgg16', 'res50'):
        jm = JRCNN(backbone=net, num_classes=2, dtype=jnp.float32)
        out[net] = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jm.init(k, image_shape=(64, 96)))(jax.random.PRNGKey(0)))
    return out


@pytest.mark.parametrize('net', ['vgg16', 'res50'])
def test_save_params_npz_reads_back_in_jax(jax_trees, net, tmp_path):
    import jax
    from tpudenoise.models.convert import load_params_npz
    from tpudenoise_torch.models.convert import from_jax_params, \
        save_params_npz
    tree = jax_trees[net]
    save_params_npz(from_jax_params(tree), str(tmp_path / 'w.npz'))
    back = load_params_npz(str(tmp_path / 'w.npz'))
    want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def _partial_trees(tree, net):
    """A head-only tree, and one with a misnested key (block4 or fc6 under
    'head' instead of 'tail/tail') and an unknown top-level entry."""
    tail = 'fc6' if net == 'vgg16' else 'block4'
    misnested = {'head': dict(tree['head'], **{tail: tree['tail']['tail'][
        tail]}), 'extra': {'w': np.zeros(2, np.float32)}}
    return {'head-only': {'head': tree['head']}, 'misnested': misnested}


@pytest.mark.parametrize('net', ['res50'])
@pytest.mark.parametrize('which', ['head-only', 'misnested'])
def test_merge_pretrained_counts_like_jax(jax_trees, port_inits, net,
                                          which):
    import torch
    from tpudenoise.train.solver import _merge_pretrained
    from tpudenoise_torch.models.convert import (from_jax_params,
                                                 merge_pretrained)
    tree, init = jax_trees[net], port_inits[net]
    pre = _partial_trees(tree, net)[which]
    outs = []
    for fn, base in ((merge_pretrained, init), (_merge_pretrained, tree)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            merged = fn(base, pre)
        outs.append((buf.getvalue(), merged))
    (got_text, got), (want_text, want) = outs
    assert got_text == want_text
    assert 'Loaded' in got_text and ('WARNING' in got_text) == (
        which == 'misnested')
    # the merged state dict is the JAX merge, converted
    want = from_jax_params(want)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]) or (
            not k.startswith('head') and torch.equal(got[k], init[k])), k
