"""`python -m tpudenoise_torch.cli.convert` (the torchvision path) against
the JAX package's `convert_torch_resnet` + `save_params_npz`, on the CPU.

A torchvision-layout resnet state dict of seeded random arrays is written
in the test (nothing is fetched): res50 at its real shapes, res101 and
res152 with every channel count cut by 16 (the converter maps names and
transposes; it reads no shape).  The port's `.npz` must hold the JAX
package's keys in the same order and bit-equal arrays of the same dtype;
the real-shape res50 file then loads into the port's detector and into
the JAX package.  Each refused source raises naming itself."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import numpy as np
import pytest
import torch

from tpudenoise_torch.cli import convert as cli
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
    (['--src', 'det.ckpt', '--net', 'res101', '--detector'],
     NotImplementedError,
     r'--detector .*TensorFlow.*tpudenoise\.cli\.convert'),
    (['--src', 'det.pth', '--net', 'res101', '--detector'],
     NotImplementedError, r'--detector .*TensorFlow'),
    (['--src', 'vgg_16.ckpt', '--net', 'vgg16'],
     NotImplementedError, r'--net vgg16 .*tf-slim.*TensorFlow'),
    (['--src', 'mobilenet_v1.ckpt', '--net', 'mobile'],
     NotImplementedError, r'--net mobile .*tf-slim.*TensorFlow'),
    (['--src', 'resnet_v1_101.ckpt', '--net', 'res101'],
     NotImplementedError, r'--net res101 .*tf-slim.*reads the \.npz'),
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
