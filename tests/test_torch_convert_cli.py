"""`python -m tpudenoise_torch.cli.convert` and the converters of
`tpudenoise_torch/models/convert.py` against the JAX package's, on the
CPU.

The torchvision path: a torchvision-layout resnet state dict of seeded
random arrays is written in the test (nothing is fetched): res50 at its
real shapes, res101 and res152 with every channel count cut by 16 (the
converter maps names and transposes; it reads no shape).  The real-shape
res50 file then loads into the port's detector and into the JAX package.

The TensorFlow path (these tests need TensorFlow, as
`tests/test_convert.py` does: it writes the checkpoints, and the JAX
converters read through it): slim res50 and mobilenet at their real
shapes from the checkpoint makers of `tests/test_convert.py`; slim vgg16
and the trained detectors (vgg16, res50, mobile: the backbone's scopes
plus the reference's rpn and cls/bbox heads from
`tests/test_convert.py::_add_detector_vars`) with the conv widths cut to
8 and 16 channels (the converters read no shape
but vgg16's fc reshapes, which keep their 4096 columns; a full-width
vgg16 written by TensorFlow takes ~50 s).  The same checkpoint file goes
to both packages: the trees must be equal leaf for leaf (np.array_equal,
the same dtype), and the CLIs' `.npz` files key for key and bit for bit.

End to end: the golden weights of `tests/test_torch_golden.py` (a
full-width vgg16 detector, 2 classes) written with the port's own
checkpoint writer under the reference's scopes go through the port's
CLI; `forward_test` with the `.npz` is then held to the numpy golden at
that file's bounds.  A `.pth` for a net that is not a resnet raises
naming itself, as the JAX CLI refuses it."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import os
import shutil

import numpy as np
import pytest
import torch

from tpudenoise_torch.cli import convert as cli
from tpudenoise_torch.models import convert as C
from tpudenoise_torch.models.convert import UNITS

WIDTHS = (64, 128, 256, 512)


def torchvision_resnet(num_layers: int, seed: int, cut: int = 1) -> dict:
    """A torchvision resnet{N} state dict of random float32 tensors (BN
    num_batches_tracked int64, the fc head included), channels / cut."""
    rng = np.random.RandomState(seed)
    sd = {}

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    def bn(name, c):
        sd[name + '.weight'] = t(c)
        sd[name + '.bias'] = t(c)
        sd[name + '.running_mean'] = t(c)
        sd[name + '.running_var'] = torch.from_numpy(
            rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[name + '.num_batches_tracked'] = torch.tensor(7)

    w0 = 64 // cut
    sd['conv1.weight'] = t(w0, 3, 7, 7)
    bn('bn1', w0)
    cin = w0
    for b, units in enumerate(UNITS[num_layers], start=1):
        w = WIDTHS[b - 1] // cut
        for u in range(units):
            base = f'layer{b}.{u}'
            sd[base + '.conv1.weight'] = t(w, cin, 1, 1)
            bn(base + '.bn1', w)
            sd[base + '.conv2.weight'] = t(w, w, 3, 3)
            bn(base + '.bn2', w)
            sd[base + '.conv3.weight'] = t(4 * w, w, 1, 1)
            bn(base + '.bn3', 4 * w)
            if u == 0:
                sd[base + '.downsample.0.weight'] = t(4 * w, cin, 1, 1)
                bn(base + '.downsample.1', 4 * w)
            cin = 4 * w
    sd['fc.weight'] = t(1000, cin)
    sd['fc.bias'] = t(1000)
    return sd


class StateDictHolder:
    """A pickled object with a `.state_dict()`, as a saved module is."""

    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd


def _jax_npz(sd: dict, num_layers: int, path: str):
    from tpudenoise.models import convert as C
    tree = C.convert_torch_resnet({k: v.numpy() for k, v in sd.items()},
                                  num_layers)
    C.save_params_npz(tree, path)


def _same_npz(got_path: str, want_path: str) -> int:
    with np.load(got_path) as got, np.load(want_path) as want:
        assert got.files == want.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert np.array_equal(got[k], want[k]), k
        return len(want.files)


@pytest.mark.parametrize('net,cut,wrap', [('res50', 1, False),
                                          ('res101', 16, True),
                                          ('res152', 16, False)])
def test_convert_matches_jax(net, cut, wrap, tmp_path, capsys):
    n = int(net[3:])
    sd = torchvision_resnet(n, seed=n, cut=cut)
    src = str(tmp_path / f'{net}.pth')
    torch.save(StateDictHolder(sd) if wrap else sd, src)
    out = str(tmp_path / 'port.npz')
    tree = cli.main(['--src', src, '--net', net, '--out', out])
    assert f'wrote {out}' in capsys.readouterr().out
    want = str(tmp_path / 'jax.npz')
    _jax_npz(sd, n, want)
    entries = _same_npz(out, want)
    # conv1 BGR-flipped and HWIO; block4 under tail/tail; no fc
    np.testing.assert_array_equal(
        tree['head']['conv1']['kernel'],
        np.transpose(sd['conv1.weight'].numpy(), (2, 3, 1, 0))[:, :, ::-1])
    assert list(tree['tail']['tail']) == ['block4']
    units = sum(UNITS[n])
    # conv1 + its BN (4), each unit's 3 convs + 3 BNs (15), 4 shortcuts (5)
    assert entries == 5 + 15 * units + 5 * 4


def test_converted_res50_loads_in_both_packages(tmp_path, capsys):
    """The real-shape res50 `.npz` merges over the port's seeded detector
    (`cli.test --model`'s path: every entry matched, `Loaded n/N` with n
    the file's entries) and reads back in the JAX package."""
    from tpudenoise.models.convert import load_params_npz as j_load
    from tpudenoise_torch.models.convert import (load_pretrained,
                                                 merge_pretrained)
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    sd = torchvision_resnet(50, seed=3)
    src, out = str(tmp_path / 'r50.pth'), str(tmp_path / 'r50.npz')
    torch.save(sd, src)
    cli.main(['--src', src, '--net', 'res50', '--out', out])
    model = FasterRCNN('res50', num_classes=2)
    init = model.state_dict()
    merged = merge_pretrained(init, load_pretrained(out, 'res50'))
    with np.load(out) as f:
        n = len(f.files)
    printed = capsys.readouterr().out
    assert f'Loaded {n}/{len(init)} parameters' in printed
    assert 'WARNING' not in printed
    assert torch.equal(merged['tail.block4.unit_3.bn3.var'],
                       sd['layer4.2.bn3.running_var'])
    assert torch.equal(merged['head.conv1.weight'],
                       sd['conv1.weight'].flip(1))
    assert torch.equal(merged['rpn.rpn_conv.weight'],
                       init['rpn.rpn_conv.weight'])
    jtree = j_load(out)
    np.testing.assert_array_equal(
        jtree['head']['block2']['unit_1']['shortcut']['kernel'],
        np.transpose(sd['layer2.0.downsample.0.weight'].numpy(),
                     (2, 3, 1, 0)))


@pytest.mark.parametrize('argv,err,match', [
    (['--src', 'vgg16.pth', '--net', 'vgg16'],
     ValueError, r'--net vgg16 from a \.pth: .*resnets'),
    (['--src', 'mobile.pt', '--net', 'mobile'],
     ValueError, r'--net mobile from a \.pth: .*resnets'),
])
def test_refused_sources_raise_naming_themselves(argv, err, match, tmp_path):
    out = tmp_path / 'x.npz'
    with pytest.raises(err, match=match):
        cli.main(argv + ['--out', str(out)])
    assert not out.exists()


# ----------------------------------------------------- TensorFlow path --

def _slim_arrays(net: str, cut: int, rng) -> dict:
    """{name: array} of a slim backbone's checkpoint, channels / cut (a
    trained detector's vgg16 keeps dense fc6/fc7)."""
    out = {}

    def var(name, *shape):
        a = rng.randn(*shape).astype(np.float32) * 0.01
        out[name] = np.abs(a) + 0.5 if name.endswith('variance') else a

    def bn(prefix, c):
        for leaf in ('gamma', 'beta', 'moving_mean', 'moving_variance'):
            var(f'{prefix}/BatchNorm/{leaf}', c)

    if net in ('vgg16', 'vgg16_detector'):
        cin = 3
        for s, rep in enumerate(C.VGG_REPS, start=1):
            for r in range(1, rep + 1):
                var(f'vgg_16/conv{s}/conv{s}_{r}/weights', 3, 3, cin, cut)
                var(f'vgg_16/conv{s}/conv{s}_{r}/biases', cut)
                cin = cut
        if net == 'vgg16':
            var('vgg_16/fc6/weights', 7, 7, cin, 4096)
            var('vgg_16/fc7/weights', 1, 1, 4096, 4096)
        else:
            var('vgg_16/fc6/weights', 49 * cin, 64)
            var('vgg_16/fc7/weights', 64, 64)
        var('vgg_16/fc6/biases', out['vgg_16/fc6/weights'].shape[-1])
        var('vgg_16/fc7/biases', out['vgg_16/fc7/weights'].shape[-1])
    elif net == 'res50':
        scope, cin = 'resnet_v1_50', 64 // cut
        var(f'{scope}/conv1/weights', 7, 7, 3, cin)
        bn(f'{scope}/conv1', cin)
        for b, units in enumerate(UNITS[50], start=1):
            w = WIDTHS[b - 1] // cut
            for u in range(1, units + 1):
                p = f'{scope}/block{b}/unit_{u}/bottleneck_v1'
                if u == 1:
                    var(f'{p}/shortcut/weights', 1, 1, cin, 4 * w)
                    bn(f'{p}/shortcut', 4 * w)
                for i, shape in ((1, (1, 1, cin, w)), (2, (3, 3, w, w)),
                                 (3, (1, 1, w, 4 * w))):
                    var(f'{p}/conv{i}/weights', *shape)
                    bn(f'{p}/conv{i}', shape[-1])
                cin = 4 * w
    else:                                                   # mobile
        scope, cin = 'MobilenetV1', 32 // cut
        var(f'{scope}/Conv2d_0/weights', 3, 3, 3, cin)
        bn(f'{scope}/Conv2d_0', cin)
        for i in range(1, 14):
            cout = cin * (2 if i in (1, 2, 4, 6, 12) else 1)
            var(f'{scope}/Conv2d_{i}_depthwise/depthwise_weights',
                3, 3, cin, 1)
            bn(f'{scope}/Conv2d_{i}_depthwise', cin)
            var(f'{scope}/Conv2d_{i}_pointwise/weights', 1, 1, cin, cout)
            bn(f'{scope}/Conv2d_{i}_pointwise', cout)
            cin = cout
    return out


def _detector_arrays(net: str, seed: int) -> dict:
    """A reference-trained detector's checkpoint: the backbone, then the
    rpn and cls/bbox heads of `tests/test_convert.py`, 3 classes."""
    from tests.test_convert import _add_detector_vars
    rng = np.random.RandomState(seed)
    out = _slim_arrays('vgg16_detector' if net == 'vgg16' else net,
                       8 if net == 'vgg16' else 16, rng)

    def var(name, shape):
        out[name] = rng.randn(*shape).astype(np.float32) * 0.01

    fc_in = {'vgg16': 64, 'res50': 2048 // 16, 'mobile': 1024 // 16}[net]
    _add_detector_vars(var, C.DETECTOR_SCOPES[net], fc_in, 3, rng)
    return out


@pytest.fixture(scope='module')
def tf_ckpts(tmp_path_factory):
    """Checkpoint prefixes written by TensorFlow, by source name (removed
    after the module's tests: the suite's temp dirs stay until it ends)."""
    pytest.importorskip('tensorflow')
    from tests.test_convert import (_make_slim_mobilenet_ckpt,
                                    _make_slim_resnet50_ckpt)
    from tests.test_torch_tf_checkpoint import tf_save
    d = tmp_path_factory.mktemp('tf_ckpts')
    out = {'res50': _make_slim_resnet50_ckpt(d),
           'mobile': _make_slim_mobilenet_ckpt(d)}
    tf_save(d / 'vgg_16.ckpt', _slim_arrays(
        'vgg16', 8, np.random.RandomState(8)))
    out['vgg16'] = str(d / 'vgg_16.ckpt')
    for seed, net in enumerate(('vgg16', 'res50', 'mobile')):
        tf_save(d / f'{net}_det.ckpt', _detector_arrays(net, seed))
        out[f'{net}_detector'] = str(d / f'{net}_det.ckpt')
    yield out
    shutil.rmtree(d)


def _same_tree(got: dict, want: dict, ordered: bool = True) -> int:
    got, want = C._flatten(got), C._flatten(want)
    assert (list(got) if ordered else sorted(got)) == \
        (list(want) if ordered else sorted(want))
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k
    return len(want)


@pytest.mark.parametrize('source,call,leaves', [
    ('res50', lambda M, p: M.convert_tf_slim_resnet(p, 50), 265),
    ('vgg16', lambda M, p: M.convert_tf_slim_vgg16(p), 30),
    ('mobile', lambda M, p: M.convert_tf_slim_mobilenet(p), 135),
    ('mobile', lambda M, p: M.convert_tf_slim_mobilenet(p, surgery=False),
     135),
    ('vgg16_detector', lambda M, p: M.convert_ref_detector(p, 'vgg16'), 40),
    ('res50_detector', lambda M, p: M.convert_ref_detector(p, 'res50'),
     275),
    ('mobile_detector', lambda M, p: M.convert_ref_detector(p, 'mobile'),
     145),
], ids=['slim_res50', 'slim_vgg16', 'slim_mobile', 'slim_mobile_no_surgery',
        'detector_vgg16', 'detector_res50', 'detector_mobile'])
def test_converters_match_jax(tf_ckpts, source, call, leaves):
    from tpudenoise.models import convert as J
    ckpt = tf_ckpts[source]
    assert _same_tree(call(C, ckpt), call(J, ckpt)) == leaves


@pytest.mark.parametrize('source,argv', [
    ('vgg16', ['--net', 'vgg16']),
    ('res50', ['--net', 'res50']),
    ('mobile', ['--net', 'mobile']),
    ('vgg16_detector', ['--net', 'vgg16', '--detector']),
    ('res50_detector', ['--net', 'res50', '--detector']),
])
def test_tensorflow_sources_match_jax_cli(tf_ckpts, source, argv, tmp_path,
                                          capsys):
    from tpudenoise.cli import convert as jcli
    args = ['--src', tf_ckpts[source]] + argv
    out, want = str(tmp_path / 'port.npz'), str(tmp_path / 'jax.npz')
    cli.main(args + ['--out', out])
    jcli.main(args + ['--out', want])
    assert f'wrote {out}' in capsys.readouterr().out
    assert _same_npz(out, want) > 0
    os.remove(out)
    os.remove(want)


def test_golden_detector_through_the_cli(tmp_path):
    """The golden vgg16 detector, written as a V2 checkpoint by the port,
    converted by the port's CLI, against the numpy golden."""
    from tests.test_torch_golden import _golden_weights, held_to_golden
    from tpudenoise_torch.models.tf_checkpoint import write_checkpoint
    tree = _golden_weights()
    scope = 'vgg_16'
    flat = {}
    for name, p in tree['head'].items():
        s = name[4]
        flat[f'{scope}/conv{s}/{name}/weights'] = p['kernel']
        flat[f'{scope}/conv{s}/{name}/biases'] = p['bias']
    for name, p in (*tree['tail']['tail'].items(), *tree['rpn'].items(),
                    *tree['tail']['rcnn'].items()):
        name = 'rpn_conv/3x3' if name == 'rpn_conv' else name
        flat[f'{scope}/{name}/weights'] = p['kernel']
        flat[f'{scope}/{name}/biases'] = p['bias']
    flat['global_step'] = np.int64(70000)
    prefix = str(tmp_path / 'vgg16_faster_rcnn_iter_70000.ckpt')
    write_checkpoint(prefix, flat)
    del flat
    out = str(tmp_path / 'det.npz')
    got = cli.main(['--src', prefix, '--net', 'vgg16', '--detector',
                    '--out', out])
    for f in tmp_path.glob('*.ckpt.*'):       # 528 MB: the suite's temp
        f.unlink()                          # dirs stay until it ends
    assert _same_tree(got, tree, ordered=False) == 40
    params = C.load_npz(out)
    os.remove(out)
    held_to_golden(params, tree)
