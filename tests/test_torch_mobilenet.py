"""The port's MobileNetV1 Faster R-CNN against the JAX package on the same
weights (carried by `from_jax_params`), on the CPU.

The model runs at MOBILENET.DEPTH_MULTIPLIER 0.25 on 64x96 images, RPN
128 -> 8, f32, from the port's seeded init (flax's lecun-normal kernels,
as the JAX init) carried to the JAX layout by `to_jax_flat`, with every
BN statistic replaced by seeded random values (the seeded BN is the
identity, and with it ReLU6 would clamp most of what the convs differ
in).

Bounds, each with its reason:
* head and tail outputs: torch and XLA sum the convs in other orders, so
  within 1e-5 of the output's largest magnitude.  ReLU6 is a clamp, so a
  value within rounding of 0 or 6 lands on the bound in one package and
  a rounding step away in the other: that moves it by the rounding only;
* forward_test as the resnet test holds it (tests/test_torch_resnet.py):
  the cls/bbox heads compute in bf16 in both packages, so cls_prob within
  1e-4 on at least 99% of its entries and 1e-3 on all, roi_mask exactly,
  each JAX roi with a port twin within 1e-2 px;
* the training step (the heads patched to f32 in both packages, as
  tests/test_torch_train_step.py does): each loss within 1e-4 relative;
  each gradient within 1e-3 of its tensor's max |g| (or 1e-9 of the
  largest gradient anywhere, for a gradient zero but for rounding); the
  parameters after the step within that bound * lr * max |g| plus 2 ulp
  of the largest |p|; frozen parameters bit-equal after the step;
* the TwoNN probes: within 1e-5 of each feature's largest magnitude, as
  tests/test_torch_twonn.py holds vgg16's and res50's.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_resnet import _randomize
from tpudenoise_torch.core.config import default_config
from tpudenoise_torch.models import convert
from tpudenoise_torch.models.backbones import mobilenet
from tpudenoise_torch.models.convert import (from_jax_params, load_npz,
                                             save_params_npz, to_jax_flat)
from tpudenoise_torch.models.faster_rcnn import FasterRCNN

SIZE = (64, 96)
DM = 0.25
OUT_TOL = 1e-5
BUCKET = (128, 192)
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
FLOOR = 1e-9


def _configs(dm=DM):
    from tpudenoise.core.config import default_config as jcfg
    jc, tc = jcfg(), default_config()
    for c in (jc, tc):
        c.MOBILENET.DEPTH_MULTIPLIER = dm
        c.TEST.RPN_PRE_NMS_TOP_N = 128
        c.TEST.RPN_POST_NMS_TOP_N = 8
    return jc, tc


def _flat(tree) -> dict:
    """'head/layer_0/conv/kernel'-style keys -> numpy, the `.npz` layout."""
    return convert._flatten(jax.tree_util.tree_map(np.asarray, tree))


def _tree(cfg, num_classes=3, **kw) -> dict:
    """The seeded mobile's weights as a JAX-layout tree (numpy), its BN
    statistics randomized."""
    m = FasterRCNN('mobile', num_classes=num_classes, cfg=cfg, **kw)
    return _randomize(convert._unflatten(convert.to_jax_flat(m.init(
        torch.Generator().manual_seed(0)))), np.random.RandomState(0))


@pytest.fixture(scope='module')
def mobile():
    from tpudenoise.models.faster_rcnn import FasterRCNN as JRCNN
    jc, tc = _configs()
    jm = JRCNN(backbone='mobile', num_classes=3, cfg=jc, dtype=jnp.float32)
    jp = _tree(tc)
    tm = FasterRCNN('mobile', num_classes=3, cfg=tc, dtype=torch.float32)
    return jm, jp, tm, from_jax_params(jp)


def _close(got: np.ndarray, want: np.ndarray, tol=OUT_TOL):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_mobile_head_matches(mobile):
    jm, jp, tm, params = mobile
    img = (np.random.RandomState(1).randn(2, *SIZE, 3) * 40).astype(
        np.float32)
    want = np.asarray(jm.head_mod.apply({'params': jp['head']},
                                        jnp.asarray(img)))
    head = {k[5:]: v for k, v in params.items() if k.startswith('head.')}
    got = torch.func.functional_call(
        tm.head, head, (torch.from_numpy(img).permute(0, 3, 1, 2),))
    assert want.shape == (2, 4, 6, 128)
    assert (want > 0).mean() > 0.2 and (want < 6).mean() > 0.5
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_mobile_tail_matches(mobile):
    """Layers 12-13 on (R, 7, 7, 128) crops, then the mean: the tail's own
    output, before the class heads."""
    from tpudenoise.models.backbones import mobilenet as jmob
    jm, jp, tm, params = mobile
    crops = np.random.RandomState(2).rand(5, 7, 7, 128).astype(
        np.float32) * 6
    want = np.asarray(jmob.MobileNetV1Tail(DM, dtype=jnp.float32).apply(
        {'params': jp['tail']['tail']}, jnp.asarray(crops)))
    tail = {k[5:]: v for k, v in params.items() if k.startswith('tail.')}
    got = torch.func.functional_call(tm.tail, tail,
                                     (torch.from_numpy(crops),))
    assert want.shape == (5, 256)
    _close(got.numpy(), want)


def test_mobile_forward_test_matches(mobile):
    jm, jp, tm, params = mobile
    rng = np.random.RandomState(3)
    imgs = (rng.randn(2, *SIZE, 3) * 40).astype(np.float32)
    info = np.asarray([[64, 96, 1.0], [60, 80, 1.0]], np.float32)
    got = tm.forward_test(params, torch.from_numpy(imgs),
                          torch.from_numpy(info))
    for i in range(2):
        w = jm.forward_test(jp, jnp.asarray(imgs[i]), jnp.asarray(info[i]))
        diff = np.abs(got['cls_prob'][i].numpy() - np.asarray(w['cls_prob']))
        assert (diff <= 1e-4).mean() >= 0.99 and diff.max() <= 1e-3, \
            diff.max()
        np.testing.assert_array_equal(got['roi_mask'][i].numpy(),
                                      np.asarray(w['roi_mask']))
        got_r = got['rois'][i].numpy()
        for row in np.asarray(w['rois']):
            assert np.abs(got_r - row).max(1).min() < 1e-2
        np.testing.assert_allclose(got['feat_pooled'][i].numpy(),
                                   np.asarray(w['feat_pooled']), atol=1e-4,
                                   rtol=1e-5)


@pytest.mark.parametrize('dm,size', [(1.0, (64, 96)), (1.0, (65, 97)),
                                     (0.25, (600, 1000))])
def test_feature_stride_and_width(dm, size):
    """Stride 16 and _depth(512) channels, as the JAX head (odd extents:
    each stride-2 layer pads 1/1, so an extent n becomes ceil(n / 2))."""
    from tpudenoise.models.backbones import mobilenet as jmob
    want = jax.eval_shape(
        lambda x: jmob.MobileNetV1Head(dm).init_with_output(
            jax.random.PRNGKey(0), x)[0],
        jax.ShapeDtypeStruct((1, *size, 3), jnp.float32)).shape
    _, tc = _configs(dm)
    m = FasterRCNN('mobile', num_classes=2, cfg=tc)
    assert m.pool_then_max and m.head.out_channels == want[-1]
    assert m.tail.out_channels == mobilenet._depth(1024, dm)
    with torch.no_grad():
        got = m.head(torch.zeros(1, 3, *size))
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (1, want[3], want[1], want[2])
    if size == (64, 96) and dm == 1.0:
        assert tuple(got.shape[1:]) == (512, 4, 6)


@pytest.mark.parametrize('fixed', [0, 5, 14])
def test_frozen_param_filter_every_path(fixed):
    """The port's filter against the JAX one on every path of the head
    (kernels as 'weight', BN leaves by name), and FasterRCNN.frozen on
    every parameter: only the head's, and within it exactly the filter's."""
    from tpudenoise.models.backbones import mobilenet as jmob
    jf = jmob.frozen_param_filter(fixed)
    tf_ = mobilenet.frozen_param_filter(fixed)
    _, tc = _configs()
    tc.MOBILENET.FIXED_LAYERS = fixed
    m = FasterRCNN('mobile', num_classes=3, cfg=tc)
    flat = to_jax_flat(m.state_dict())
    heads = [n for n in m.state_dict() if n.startswith('head.')]
    assert len(heads) == len([k for k in flat if k.startswith('head/')])
    for name in heads:
        jpath = name.split('.')[1:-1] + [_jax_leaf(name)]
        assert 'head/' + '/'.join(jpath) in flat, name
        assert tf_(name.split('.')[1:]) == jf(jpath), name
    for n, _ in m.named_parameters():
        want = n.startswith('head.') and jf(
            n.split('.')[1:-1] + [_jax_leaf(n)])
        assert m.frozen(n) == want, n
    # in the head BN statistics are buffers; in the tail, parameters
    names = dict(m.named_parameters())
    assert not any('bn' in n for n in names if n.startswith('head.'))
    assert any('bn' in n for n in names if n.startswith('tail.'))


def _jax_leaf(name: str) -> str:
    leaf = name.rsplit('.', 1)[1]
    return 'kernel' if leaf == 'weight' else leaf


def test_params_round_trip(mobile, tmp_path):
    """from_jax_params and to_jax_flat are inverses on a mobile tree, and
    `.npz` files go both ways between the packages."""
    from tpudenoise.models.convert import load_params_npz as j_load
    from tpudenoise.models.convert import save_params_npz as j_save
    _, jp, tm, params = mobile
    assert set(params) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert params[k].shape == v.shape, k
    assert params['head.layer_1.depthwise.weight'].shape == (8, 1, 3, 3)
    assert params['head.layer_1.pointwise.weight'].shape == (16, 8, 1, 1)
    want = _flat(jp)
    got = to_jax_flat(params)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    j_save(jp, str(tmp_path / 'jax.npz'))
    loaded = load_npz(str(tmp_path / 'jax.npz'))
    for k in params:
        assert torch.equal(loaded[k], params[k]), k
    save_params_npz(params, str(tmp_path / 'port.npz'))
    back = _flat(j_load(str(tmp_path / 'port.npz')))
    for k in want:
        assert np.array_equal(back[k], want[k]), k
    # a backbone-only tree merges over an init, leaf for leaf
    merged = convert.merge_pretrained(tm.state_dict(), {'head': jp['head']})
    for k, v in params.items():
        assert torch.equal(merged[k], v if k.startswith('head.')
                           else tm.state_dict()[k]), k


@pytest.mark.parametrize('dm,leaves', [(1.0, 145), (0.5, 145)])
def test_state_dict_matches_jax_tree(dm, leaves):
    """Keys and shapes against `jax.eval_shape` of the JAX init."""
    from tpudenoise.models.faster_rcnn import FasterRCNN as JRCNN
    jc, tc = _configs(dm)
    jm = JRCNN(backbone='mobile', num_classes=21, cfg=jc)
    shapes = jax.eval_shape(lambda k: jm.init(k, SIZE),
                            jax.random.PRNGKey(0))
    assert len(jax.tree_util.tree_leaves(shapes)) == leaves
    got = from_jax_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    want = FasterRCNN('mobile', num_classes=21, cfg=tc).state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k


# ------------------------------------------------------ training step --

@pytest.fixture(scope='module')
def mobile_step():
    """One step of both packages from the same randomized JAX init, the
    cls/bbox heads in f32 in both (see the module docstring)."""
    import tpudenoise.models.faster_rcnn as jfr
    from tests.test_torch_train_step import SCALES, _batch, _jax_grads
    from tpudenoise.train.train_step import TrainState
    from tpudenoise.train.train_step import make_optimizer as j_optimizer
    from tpudenoise.train.train_step import make_train_step as j_make_step
    from tpudenoise_torch.train.train_step import (l2_regularization,
                                                   make_train_step)
    jc, tc = _configs()
    for c in (jc, tc):
        c.TRAIN.LEARNING_RATE = 0.01
    saved = jfr.RCNNHead
    jfr.RCNNHead = functools.partial(saved, dtype=jnp.float32)
    try:
        jm = jfr.FasterRCNN(backbone='mobile', num_classes=3, cfg=jc,
                            anchor_scales=SCALES, dtype=jnp.float32)
        _, j_step = j_make_step(jm, jc)
        # the JAX step's own state for these weights (its init_state with
        # the port's seeded weights in place of flax's draws)
        params = _tree(tc, anchor_scales=SCALES)
        tx, _ = j_optimizer(jc, {'head': jm.frozen_filter, 'rpn': None,
                                 'tail': None})
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jstate = TrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32))
        batch = _batch()
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        k_step = jax.random.PRNGKey(9)
        j_losses, j_grads = _jax_grads(jm, jstate.params, k_step, jbatch,
                                       jc.TRAIN.WEIGHT_DECAY)
        jnew, _ = j_step(jstate, k_step, jbatch)
    finally:
        jfr.RCNNHead = saved
    tm = FasterRCNN('mobile', num_classes=3, cfg=tc, anchor_scales=SCALES,
                    dtype=torch.float32)
    tm.rcnn.dtype = torch.float32
    sd = from_jax_params(params)
    tm.init = lambda generator, image_shape: {k: sd[k].clone()
                                              for k in tm.state_dict()}
    t_init, t_step = make_train_step(tm, tc)
    state = t_init(None, BUCKET)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    key = np.asarray(k_step)
    trainable = [n for n, _ in tm.named_parameters() if not tm.frozen(n)]
    p = dict(state.params)
    for n in trainable:
        p[n] = p[n].clone().requires_grad_(True)
    losses = tm.forward_train(p, key, tbatch['image'], tbatch['im_info'],
                              tbatch['gt_boxes'], tbatch['gt_mask'])
    losses['total_loss'] = losses['total_loss'] + l2_regularization(
        p, tc.TRAIN.WEIGHT_DECAY)
    grads = dict(zip(trainable, torch.autograd.grad(
        losses['total_loss'], [p[n] for n in trainable])))
    new, _ = t_step(state, key, tbatch)
    return dict(tm=tm, jm=jm, j_losses=j_losses, j_grads=_flat(j_grads),
                jnew=_flat(jnew.params), losses=losses, grads=grads,
                state=state, new=new, lr=tc.TRAIN.LEARNING_RATE)


def test_mobile_step_losses_match(mobile_step):
    s = mobile_step
    for name, v in s['j_losses'].items():
        want, got = float(v), s['losses'][name].item()
        assert np.isfinite(got)
        assert abs(got - want) <= LOSS_RTOL * abs(want), (name, got, want)
    assert s['losses']['loss_box'].item() > 0


def test_mobile_step_gradients_match(mobile_step):
    s = mobile_step
    jg = s['j_grads']
    floor = FLOOR * max(np.abs(v).max() for v in jg.values())
    assert len(s['grads']) > 0
    for n, g in s['grads'].items():
        jname, got = next(iter(to_jax_flat({n: g}).items()))
        err = np.abs(got - jg[jname]).max()
        assert err <= max(GRAD_TOL * np.abs(jg[jname]).max(), floor), \
            (n, err)


def test_mobile_step_params_match(mobile_step):
    """The step's parameters as the JAX step's; the frozen ones (the first
    FIXED_LAYERS layers, every head BN) bit-equal to before, the tail's BN
    moved (it trains in both packages)."""
    s = mobile_step
    got = to_jax_flat(s['new'].params)
    gmax = {next(iter(to_jax_flat({n: g}))): g.abs().max().item()
            for n, g in s['grads'].items()}
    for name, want in s['jnew'].items():
        ulp2 = 2 * np.spacing(np.abs(want).max())
        bound = GRAD_TOL * s['lr'] * 2 * gmax.get(name, 0.0) + ulp2
        assert np.abs(got[name] - want).max() <= bound, name
    tm = s['tm']
    frozen = [n for n, _ in tm.named_parameters() if tm.frozen(n)]
    assert 'head.layer_0.conv.weight' in frozen
    assert 'head.layer_4.pointwise.weight' in frozen
    assert 'head.layer_5.pointwise.weight' not in frozen
    for n in frozen:
        assert torch.equal(s['new'].params[n], s['state'].params[n]), n
        assert not s['new'].momentum[n].any(), n
    for n in ('head.layer_5.pointwise.weight', 'tail.layer_13.pw_bn.gamma'):
        assert not torch.equal(s['new'].params[n], s['state'].params[n]), n


# ------------------------------------------------------------ TwoNN ----

def test_mobile_probe_features_match_jax(mobile):
    """The six pointwise probes and 'head', pooled over each image's valid
    extent, against the JAX package's make_probe_fn."""
    from tpudenoise.analysis import twonn as jt
    from tpudenoise_torch.analysis import twonn as tt
    jm, jp, tm, params = mobile
    hw = np.array([[64, 96], [50, 70], [33, 96], [64, 40]], np.int64)
    imgs = (np.random.RandomState(4).randn(len(hw), *SIZE, 3) * 40).astype(
        np.float32)
    want = jt.make_probe_fn(jm)({'head': jp['head']}, jnp.asarray(imgs),
                                jnp.asarray(hw, jnp.int32))
    got = tt.make_probe_fn(tm)(params, torch.from_numpy(imgs), hw)
    # the JAX function's dict comes back from jit with sorted keys
    assert list(got) == tt.PROBES['mobile'] + ['head']
    assert sorted(got) == sorted(want)
    assert tt.PROBES['mobile'] == jt.PROBES['mobile']
    for p, w in want.items():
        w = np.asarray(w)
        assert got[p].shape == w.shape and got[p].dtype == torch.float32
        err = np.abs(got[p].numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-5, (p, err)

