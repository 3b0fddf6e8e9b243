"""The training step (counterpart of `tpudenoise/train/train_step.py`):
SGD with momentum in optax's order, written on tensors.

For each trainable parameter, in this order:
  1. the gradient, zeroed where the parameter is frozen (its momentum
     then stays empty, as the JAX step's masked gradients keep it);
  2. optional global-norm clipping (TRAIN.GRAD_CLIP > 0), over every
     gradient: g * max_norm / norm where norm >= max_norm;
  3. biases x2 (TRAIN.DOUBLE_BIAS), before the momentum trace;
  4. trace: m = g + MOMENTUM * m;
  5. p = p + (-lr) * m, lr the schedule at the step count before the
     update (optax's `scale_by_learning_rate`).

The parameters are the model's `named_parameters()`; `model.frozen`
marks the head's frozen ones, which is the JAX step's `trainable_mask`
(its freeze filter covers the 'head' tree only, so the resnet tail's BN
gamma, beta, mean and var train, at 1x the rate and without weight
decay: `bias_mask` and the L2 term take only 'bias' and 'kernel'
leaves).  The loss is the batch mean of `FasterRCNN.forward_train` plus
the L2 term over every conv and dense kernel, frozen ones too.  Parameters stay f32;
the model computes in its dtype (bf16 by default) through differentiable
casts, so gradients land in f32.  The step count lives on the host, so
the learning rate never waits on the device.

With a mesh (data parallelism, `core.mesh`), each rank's batch is its
rows of the global batch of B = rows x ranks images, and the step is the
JAX step on the global batch: image i of the global batch takes key i of
split(key, B); each rank differentiates its rows' mean / ranks (rank 0
adds the L2 term, so it counts once), one all-reduce sums the gradients
(flattened into one buffer) before the clip, and the reported losses are
all-reduced the same way, so every rank holds the global batch's means
and applies the same update: the parameters stay replicated.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from tpudenoise_torch.core import prng
from tpudenoise_torch.core.config import AttrDict


def lr_schedule(cfg: AttrDict):
    """count -> f32 learning rate: optax's piecewise_constant_schedule of
    LEARNING_RATE scaled by GAMMA at each STEPSIZE boundary (the rate
    changes once count >= boundary), times min(1, (count + 1) / warmup)
    when TRAIN.WARMUP_ITERS > 0.  Evaluated in f32 as optax does."""
    f32 = np.float32
    init = f32(cfg.TRAIN.LEARNING_RATE)
    bounds = sorted({int(s): f32(cfg.TRAIN.GAMMA)
                     for s in cfg.TRAIN.STEPSIZE}.items())
    warmup = int(cfg.TRAIN.get('WARMUP_ITERS', 0))

    def sched(count: int) -> np.float32:
        v = init
        for threshold, scale in bounds:
            indicator = f32(max(0.0, np.sign(threshold - count)))
            v = v * indicator + (f32(1.0) - indicator) * scale * v
        if warmup > 0:
            v = v * min(f32(1.0), f32(count + 1) / f32(warmup))
        return f32(v)

    return sched


def is_kernel(name: str) -> bool:
    """A conv or dense kernel (the JAX tree's 'kernel' leaves)."""
    return name.endswith('.weight')


def is_bias(name: str) -> bool:
    return name.endswith('.bias')


def l2_regularization(params: dict, weight_decay: float) -> torch.Tensor:
    """wd * sum(w^2) / 2 over every kernel (biases and BN excluded)."""
    terms = [weight_decay * 0.5 * (w.to(torch.float32) ** 2).sum()
             for name, w in sorted(params.items()) if is_kernel(name)]
    return torch.stack(terms).sum()


class TrainState(NamedTuple):
    params: dict        # the state dict: parameters (f32) and buffers
    momentum: dict      # one trace per trainable parameter
    step: int


def _all_reduce_flat(tensors, group):
    """The sum over the group's ranks of each tensor, by one all-reduce of
    their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def make_train_step(model, cfg: AttrDict, mesh=None):
    """Returns (init_state, step_fn).

    init_state(generator, image_shape) -> TrainState: the seeded init
    (`model.init`) and empty momentum.  step_fn(state, key, batch,
    update=True) -> (state, losses): batch holds device tensors image
    (B, H, W, 3) preprocessed, im_info (B, 3), gt_boxes (B, G, 5),
    gt_mask (B, G); key is a (2,) uint32 host key.  losses are detached
    device scalars (total_loss with the L2 term).  update=False computes
    the losses only and returns the state unchanged (the validation
    losses).  mark(stage), when given, is called as each stage's work has
    been queued: 'forward' (forward and losses), 'backward' and
    'optimizer' (the profiling hook of the stage split).  mesh: batch
    holds this rank's rows of the global batch (module docstring)."""
    names = [n for n, _ in model.named_parameters()]
    trainable = [n for n in names if not model.frozen(n)]
    wd = cfg.TRAIN.WEIGHT_DECAY
    clip = float(cfg.TRAIN.get('GRAD_CLIP', 0.0) or 0.0)
    decay = cfg.TRAIN.MOMENTUM
    double_bias = bool(cfg.TRAIN.DOUBLE_BIAS)
    schedule = lr_schedule(cfg)

    def init_state(generator, image_shape=(608, 1024)) -> TrainState:
        params = model.init(generator, image_shape)
        return TrainState(params, {n: torch.zeros_like(params[n])
                                   for n in names}, 0)

    if mesh is not None:
        group = mesh.get_group('data')
        n_ranks = dist.get_world_size(group)
        rank = dist.get_rank(group)

    def losses_of(params, key, batch):
        """(the objective to differentiate, the losses to report)."""
        b = batch['image'].shape[0]
        image_keys = None
        if mesh is not None:
            image_keys = prng.split(key, b * n_ranks)[rank * b:
                                                      (rank + 1) * b]
        losses = model.forward_train(params, key, batch['image'],
                                     batch['im_info'], batch['gt_boxes'],
                                     batch['gt_mask'], image_keys)
        reg = l2_regularization(params, wd)
        if mesh is None:
            losses['total_loss'] = losses['total_loss'] + reg
            return losses['total_loss'], losses
        objective = losses['total_loss'] / n_ranks
        if rank == 0:
            objective = objective + reg
        terms = sorted(losses)
        sums = _all_reduce_flat(
            [losses[k].detach().reshape(1) for k in terms], group)
        losses = {k: v[0] / n_ranks for k, v in zip(terms, sums)}
        losses['total_loss'] = losses['total_loss'] + reg.detach()
        return objective, losses

    def step_fn(state: TrainState, key, batch, update: bool = True,
                mark=None):
        if not update:
            with torch.no_grad():
                return state, losses_of(state.params, key, batch)[1]
        mark = mark or (lambda stage: None)
        params = dict(state.params)
        for n in trainable:
            params[n] = params[n].detach().requires_grad_(True)
        objective, losses = losses_of(params, key, batch)
        mark('forward')
        grads = torch.autograd.grad(objective,
                                    [params[n] for n in trainable])
        if mesh is not None:
            grads = _all_reduce_flat(grads, group)
        mark('backward')
        with torch.no_grad():
            if clip > 0:
                norm = torch.sqrt(sum((g * g).sum() for g in grads))
                grads = [torch.where(norm < clip, g, g / norm * clip)
                         for g in grads]
            step_size = -float(schedule(state.step))
            new_params, momentum = dict(state.params), dict(state.momentum)
            for n, g in zip(trainable, grads):
                if double_bias and is_bias(n):
                    g = g * 2.0
                m = g + decay * momentum[n]
                momentum[n] = m
                new_params[n] = state.params[n] + step_size * m
        mark('optimizer')
        return (TrainState(new_params, momentum, state.step + 1),
                {k: v.detach() for k, v in losses.items()})

    return init_state, step_fn
