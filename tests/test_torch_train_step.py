"""One training step of the port against the JAX package's, on the CPU, in
f32: a vgg16 (dropout masks drawn as flax draws them) and a res50
(RESNET.FIXED_BLOCKS 1, the conv3 kernels and BN statistics randomized as
tests/test_torch_resnet.py does), both from the same JAX init carried by
`from_jax_params`, on a (128, 192) bucket, batch 2 (one image padded).

Both packages build the cls/bbox heads in bf16 whatever the model's
dtype, so a head gradient is defined only to a bf16 ulp, and that error
flows back into every tensor the RoI loss reaches.  So each backbone runs
with the heads patched to f32 in both packages (all f32), and vgg16 once
more with the heads as built (bf16).

Bounds, each stated with its reason:
* each loss term within 1e-4 relative (torch and XLA sum the convs and
  dense layers in other orders; with bf16 heads a value on a bf16
  rounding boundary can move);
* each trainable tensor's gradient: max |diff| within GRAD_TOL = 1e-3 of
  that tensor's max |g| (the same sums, through the backward; measured
  at most 9.8e-4, on vgg16's conv4_2 kernel, 1.3e-4 the median),
  BF16_TOL = 2^-7 (two bf16 ulps) with the bf16 heads, or within FLOOR
  of the largest gradient of any tensor where that is larger (a
  gradient that is zero but for rounding, as a bias whose terms cancel).
  One entry is held apart, by name (RELU_BOUNDARY): in vgg16's conv4_2 a
  ReLU input lies within rounding of 0 and falls on the other side in
  the two packages, which moves one channel of the bias gradient by
  1.32e-3 of its max |g|; that entry alone is held within 1.5e-3, every
  other entry of the tensor within the bound above;
* the frozen parameter sets equal, name for name (JAX path <-> state
  dict key), and frozen parameters unchanged by the step.  The optimizer
  masks equal the JAX step's own (`make_optimizer`'s `trainable_mask`
  and `bias_mask`, and the L2 term's kernels), leaf for leaf: the JAX
  step freezes by a filter over the 'head' tree only, so the resnet
  tail's BN (block4's gamma, beta, mean and var) trains in both
  packages, at 1x the rate and without weight decay, and is compared
  like every other parameter;
* the parameters after the step: max |diff| within that bound * lr * 2 *
  max |g| of each tensor (one step of SGD from equal parameters, biases
  doubled), plus 2 ulp of its largest |p| (the rounding of p + update).
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudenoise.core.config import default_config as jax_config
from tpudenoise.models.faster_rcnn import FasterRCNN as JaxRCNN
from tpudenoise.train.train_step import (_is_kernel as j_is_kernel,
                                         l2_regularization as j_l2,
                                         make_optimizer as j_make_optimizer,
                                         make_train_step as j_make_step)
from tpudenoise_torch.core.config import default_config
from tpudenoise_torch.models.convert import from_jax_params, to_jax_flat
from tpudenoise_torch.models.faster_rcnn import FasterRCNN
from tpudenoise_torch.train.train_step import (is_bias, is_kernel,
                                               l2_regularization,
                                               make_train_step)

BUCKET = (128, 192)
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
# tensor -> (entries allowed past the bound, their bound): see the module
# docstring
RELU_BOUNDARY = {'head.conv4_2.bias': (1, 1.5e-3)}
BF16_TOL = 2.0 ** -7
FLOOR = 1e-9
NUM_CLASSES = 3
# anchors of 32-128 px, so that many lie inside the small images
SCALES = (2, 4, 8)


def _batch():
    rng = np.random.RandomState(4)
    # pixels in [-1, 1]: with [-100, 100] the seeded res50's RoI head
    # saturates its softmax and takes no gradient
    img = (rng.rand(2, *BUCKET, 3) * 2 - 1).astype(np.float32)
    img[1, 110:] = 0.0
    img[1, :, 170:] = 0.0
    info = np.array([[128, 192, 1.0], [110, 170, 1.0]], np.float32)
    gt = np.zeros((2, 5, 5), np.float32)
    gm = np.zeros((2, 5), bool)
    for b, boxes in enumerate(([[20, 30, 90, 100, 1], [100, 10, 180, 60, 2],
                                [60, 60, 120, 120, 1]],
                               [[10, 10, 70, 90, 2], [90, 40, 160, 100, 1]])):
        gt[b, :len(boxes)] = boxes
        gm[b, :len(boxes)] = True
    return {'image': img, 'im_info': info, 'gt_boxes': gt, 'gt_mask': gm}


def _configs():
    jc, tc = jax_config(), default_config()
    for c in (jc, tc):
        c.TRAIN.LEARNING_RATE = 0.01
        c.RESNET.FIXED_BLOCKS = 1
    return jc, tc


def _jax_grads(model, params, key, batch, wd):
    """The JAX step's loss_fn and its gradients (train_step.py:130-146)."""
    def loss_fn(p):
        keys = jax.random.split(key, 2)
        losses = jax.vmap(lambda k, im, info, gt, gm: model.forward_train(
            p, k, im, info, gt, gm))(keys, batch['image'], batch['im_info'],
                                     batch['gt_boxes'], batch['gt_mask'])
        losses = jax.tree_util.tree_map(jnp.mean, losses)
        losses['total_loss'] = losses['total_loss'] + j_l2(p, wd)
        return losses['total_loss'], losses
    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return losses, grads


@pytest.fixture(scope='module', params=[('vgg16', 'f32'), ('res50', 'f32'),
                                        ('vgg16', 'bf16')],
                ids=['vgg16', 'res50', 'vgg16-bf16-heads'])
def step_pair(request):
    backbone, heads = request.param
    import tpudenoise.models.faster_rcnn as jfr
    saved = jfr.RCNNHead
    if heads == 'f32':
        # the cls/bbox heads in f32 too (both packages build them in bf16
        # whatever the model's dtype)
        jfr.RCNNHead = functools.partial(saved, dtype=jnp.float32)
    try:
        return run_step(backbone, heads)
    finally:
        jfr.RCNNHead = saved


# backbone -> the JAX init state: the two vgg16 fixtures start from the
# same one (the heads' compute dtype leaves the parameters alone), so it
# is drawn once (~9 s on the CPU).  res50's init runs jitted (~10 s, ~23
# s eagerly); its draws differ from the eager init's in last bits, and
# both packages start from it, conv3 and BN then randomized
_JAX_INIT = {}


def run_step(backbone: str, heads: str) -> dict:
    """Both packages' step from the same init: losses, gradients, states."""
    jc, tc = _configs()
    jmodel = JaxRCNN(backbone=backbone, num_classes=NUM_CLASSES, cfg=jc,
                     anchor_scales=SCALES, dtype=jnp.float32)
    j_init, j_step = j_make_step(jmodel, jc)
    key = jax.random.PRNGKey(5)
    if backbone not in _JAX_INIT:
        _JAX_INIT[backbone] = (jax.jit(j_init, static_argnums=1)
                               if backbone == 'res50' else j_init)(key,
                                                                  BUCKET)
    jstate = _JAX_INIT[backbone]
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    if backbone == 'res50':
        from tests.test_torch_resnet import _randomize
        rng = np.random.RandomState(0)
        params = {'head': _randomize(params['head'], rng),
                  'rpn': params['rpn'],
                  'tail': {'tail': _randomize(params['tail']['tail'], rng),
                           'rcnn': params['tail']['rcnn']}}
        jstate = jstate._replace(params=jax.tree_util.tree_map(
            jnp.asarray, params))
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    k_step = jax.random.PRNGKey(9)
    j_losses, j_grads = _jax_grads(jmodel, jstate.params, k_step, jbatch,
                                   jc.TRAIN.WEIGHT_DECAY)
    jnew, j_step_losses = j_step(jstate, k_step, jbatch)

    model = FasterRCNN(backbone, num_classes=NUM_CLASSES, cfg=tc,
                       anchor_scales=SCALES, dtype=torch.float32)
    if heads == 'f32':
        model.rcnn.dtype = torch.float32
    sd = from_jax_params(params)
    t_init, t_step = make_train_step(model, tc)
    # the init state on the JAX init's parameters: the seeded draws that
    # init_state would make (~10 s for vgg16) are replaced by them
    model.init = lambda generator, image_shape: {
        k: sd[k].clone() for k in model.state_dict()}
    state = t_init(None, BUCKET)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    key_np = np.asarray(k_step)
    # the port's gradients through its own loss
    trainable = [n for n, _ in model.named_parameters()
                 if not model.frozen(n)]
    p = dict(state.params)
    for n in trainable:
        p[n] = p[n].clone().requires_grad_(True)
    t_losses = model.forward_train(p, key_np, tbatch['image'],
                                   tbatch['im_info'], tbatch['gt_boxes'],
                                   tbatch['gt_mask'])
    t_losses['total_loss'] = t_losses['total_loss'] + l2_regularization(
        p, tc.TRAIN.WEIGHT_DECAY)
    grads = dict(zip(trainable, torch.autograd.grad(
        t_losses['total_loss'], [p[n] for n in trainable])))
    new, step_losses = t_step(state, key_np, tbatch)
    return dict(model=model, jmodel=jmodel, jstate=jstate,
                j_losses=j_losses,
                j_grads=j_grads, jnew=jnew, j_step_losses=j_step_losses,
                t_losses=t_losses, grads=grads, state=state, new=new,
                step_losses=step_losses, lr=tc.TRAIN.LEARNING_RATE,
                tol=GRAD_TOL if heads == 'f32' else BF16_TOL)


def _flat_jax(tree):
    """'head/conv1_1/kernel'-style keys -> numpy, as the `.npz` layout."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out['/'.join(str(getattr(k, 'key', k)) for k in path)] = np.asarray(
            leaf)
    return out


def _is_bn(name: str) -> bool:
    return name.rsplit('/', 1)[1] in ('gamma', 'beta', 'mean', 'var')


def _as_jax(sd: dict) -> dict:
    return to_jax_flat(sd)


def test_losses_match(step_pair):
    s = step_pair
    for name, v in s['j_losses'].items():
        want, got = float(v), s['t_losses'][name].item()
        assert abs(got - want) <= LOSS_RTOL * abs(want), (name, got, want)
        assert np.isfinite(got)
    for name, v in s['j_step_losses'].items():
        got = s['step_losses'][name].item()
        assert abs(got - float(v)) <= LOSS_RTOL * abs(float(v)), name


def test_frozen_sets_equal(step_pair):
    s = step_pair
    jm = s['jmodel']
    jflat = _flat_jax(s['j_grads'])
    j_frozen = {k for k in jflat if k.startswith('head/')
                and jm.frozen_filter(k.split('/')[1:])
                and k.endswith(('/kernel', '/bias'))}
    model = s['model']
    t_frozen = {n for n, _ in model.named_parameters() if model.frozen(n)}
    assert set(_as_jax({n: s['state'].params[n] for n in t_frozen})) == \
        j_frozen
    assert j_frozen
    for n in t_frozen:
        assert torch.equal(s['new'].params[n], s['state'].params[n]), n
        assert not s['new'].momentum[n].any(), n


def test_gradients_match(step_pair):
    s = step_pair
    jflat = _flat_jax(s['j_grads'])
    # a tensor whose gradient is zero but for rounding (a bias whose
    # terms cancel) is held to FLOOR of the largest gradient anywhere
    floor = FLOOR * max(np.abs(v).max() for v in jflat.values())
    for n, g in s['grads'].items():
        jname, got = next(iter(_as_jax({n: g}).items()))
        scale = np.abs(jflat[jname]).max()
        diff = np.abs(got - jflat[jname])
        err = diff.max()
        bound = max(s['tol'] * scale, floor)
        print(f'{n}: max |diff| {err:.3g} of max |g| {scale:.3g}, '
              f'{int((diff > bound).sum())} entries past {bound:.3g}')
        if n in RELU_BOUNDARY and s['tol'] == GRAD_TOL:
            n_past, tol = RELU_BOUNDARY[n]
            assert (diff > bound).sum() <= n_past, (n, err, scale)
            bound = tol * scale
        assert err <= bound, (n, err, scale)


def test_params_after_step_match(step_pair):
    s = step_pair
    jflat = _flat_jax(s['jnew'].params)
    got = _as_jax(s['new'].params)
    gmax = {next(iter(_as_jax({n: g}))): g.abs().max().item()
            for n, g in s['grads'].items()}
    boundary = {next(iter(_as_jax({n: s['grads'][n]}))): v
                for n, v in RELU_BOUNDARY.items()
                if n in s['grads'] and s['tol'] == GRAD_TOL}
    for name, want in jflat.items():
        # plus the f32 rounding of p + update: 2 ulp of the largest |p|
        ulp2 = 2 * np.spacing(np.abs(want).max())
        bound = s['tol'] * s['lr'] * 2 * gmax.get(name, 0.0) + ulp2
        diff = np.abs(got[name] - want)
        if name in boundary:
            n_past, tol = boundary[name]
            assert (diff > bound).sum() <= n_past, name
            bound = tol * s['lr'] * 2 * gmax[name] + ulp2
        err = diff.max()
        assert err <= bound, (name, err, bound)


def test_optimizer_masks_match(step_pair):
    """Which leaves train, take the doubled bias rate and the L2 term: the
    port's `model.frozen`, `is_bias` and `is_kernel` against the JAX
    step's `trainable_mask`, `bias_mask` and kernel leaves, leaf for leaf
    (buffers are never trained in the port, so a JAX leaf that trains is
    a port parameter)."""
    s = step_pair
    jm = s['jmodel']
    _, trainable_mask = j_make_optimizer(
        _configs()[0], {'head': jm.frozen_filter, 'rpn': None, 'tail': None})
    params = s['jstate'].params
    j_train = _flat_jax(jax.tree_util.tree_map(
        np.asarray, trainable_mask(params)))
    j_kernel = _flat_jax(jax.tree_util.tree_map_with_path(
        lambda p, _: np.asarray(j_is_kernel(p)), params))
    model = s['model']
    names = dict(model.named_parameters())
    for n, v in s['state'].params.items():
        jname = next(iter(_as_jax({n: v})))
        trains = n in names and not model.frozen(n)
        assert trains == bool(j_train[jname]), n
        assert is_bias(n) == (jname.rsplit('/', 1)[1] == 'bias'), n
        assert is_kernel(n) == bool(j_kernel[jname]), n
    tail_bn = [n for n in names if n.startswith('tail.') and _is_bn(
        n.replace('.', '/'))]
    assert (len(tail_bn) > 0) == (s['model'].backbone == 'res50')
    for n in tail_bn:
        assert not torch.equal(s['new'].params[n], s['state'].params[n]), n
