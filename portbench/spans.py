"""The benchmark's hooks around the calls that `test_net_batched` makes
into each layer of the program, installed from this file (the program is
not edited):

* `noise_chunk`, `prep_on_device`, `FasterRCNN.forward_test`,
  `postprocess_detections_pyramid` and `_write_and_evaluate` of
  `tpudenoise_torch.eval.harness` (and `proposal_layer` of
  `models/faster_rcnn.py`, to keep its inputs), each inside a
  `torch.profiler.record_function('pb.<layer>')` span while a trace is
  taken;
* `tpudenoise_torch.cuda_build.launch`, the one door of the port's
  hand-written kernels, inside a 'pb.kernel.<entry>' span while a trace
  is taken, with each launch's arguments kept for its least time
  (`kernels/<entry>.py`).

The same hooks keep the sampled chunks' outputs for `check.py` in every
run, traced or not: the noisy frames, the RPN's outputs, the detector's
outputs and the
detections written to detections.pkl.
"""

from __future__ import annotations

import contextlib

import torch

LAYERS = ('noise', 'prep', 'forward', 'postprocess', 'evaluate')


class Recorder:
    def __init__(self, sample: dict):
        self.sample = sample          # {row: chunk} to keep
        self.row = None
        self.chunk = 0
        self.tracing = False
        self.kept = {}                # (row, chunk) -> outputs
        self.launches = []            # (entry, argument summary) traced
        self.meta = {}                # row -> (noise, rng_seed)

    def start_row(self, row, noise: str, rng_seed: int):
        self.row, self.chunk = row, 0
        self.meta[row] = (noise, rng_seed)

    def span(self, name: str):
        if self.tracing:
            return torch.profiler.record_function('pb.' + name)
        return contextlib.nullcontext()

    def _keep(self):
        want = self.sample.get(self.row)
        if want is None or want != self.chunk - 1:
            return None
        return self.kept.setdefault((self.row, want), {})


def _summary(a):
    if isinstance(a, torch.Tensor):
        # small tables (a mix's kinds) are kept to count their work
        return ('tensor', tuple(a.shape), str(a.dtype),
                a.detach().clone() if a.numel() <= 4096 else None)
    return a


def install(rec: Recorder, model):
    """Wrap the program's layer calls (module attributes, read at call
    time) and its kernel door; returns the function that puts the
    originals back."""
    from tpudenoise_torch import cuda_build
    from tpudenoise_torch.eval import harness as H
    from tpudenoise_torch.models import faster_rcnn as FR

    noise_chunk = H.noise_chunk
    prep = H.prep_on_device
    post = H.postprocess_detections_pyramid
    write = H._write_and_evaluate
    forward = model.forward_test
    launch = cuda_build.launch
    proposal = FR.proposal_layer

    def noise_hook(key, idx, raw_u8, noise_fn, hw=None):
        with rec.span('noise'):
            out = noise_chunk(key, idx, raw_u8, noise_fn, hw)
        rec.chunk += 1
        kept = rec._keep()
        if kept is not None:
            kept['idx'] = [int(i) for i in idx]
            kept['noisy'] = out
        return out

    def prep_hook(*a, **k):
        with rec.span('prep'):
            return prep(*a, **k)

    def forward_hook(params, images, im_info):
        with rec.span('forward'):
            out = forward(params, images, im_info)
        kept = rec._keep()
        if kept is not None:
            kept['fwd'] = {k: out[k] for k in ('rois', 'roi_mask',
                                               'cls_score', 'bbox_pred',
                                               'cls_prob')}
            kept['fwd']['im_info'] = im_info
        return out

    def proposal_hook(scores, deltas, *a, **k):
        kept = rec._keep()
        if kept is not None:
            kept['rpn'] = {'scores': scores, 'deltas': deltas}
        return proposal(scores, deltas, *a, **k)

    def post_hook(*a, **k):
        with rec.span('postprocess'):
            return post(*a, **k)

    def write_hook(imdb_obj, all_boxes, output_dir, feats):
        with rec.span('evaluate'):
            res = write(imdb_obj, all_boxes, output_dir, feats)
        want = rec.sample.get(rec.row)
        kept = rec.kept.get((rec.row, want))
        if kept is not None:
            kept['dets'] = [[all_boxes[c][i].copy()
                             for c in range(1, len(all_boxes))]
                            for i in kept['idx']]
        return res

    def launch_hook(name, entry, *args):
        if not rec.tracing:
            return launch(name, entry, *args)
        rec.launches.append((entry, [_summary(a) for a in args]))
        with torch.profiler.record_function('pb.kernel.' + entry):
            return launch(name, entry, *args)

    H.noise_chunk = noise_hook
    H.prep_on_device = prep_hook
    H.postprocess_detections_pyramid = post_hook
    H._write_and_evaluate = write_hook
    model.forward_test = forward_hook
    cuda_build.launch = launch_hook
    FR.proposal_layer = proposal_hook

    def restore():
        H.noise_chunk = noise_chunk
        H.prep_on_device = prep
        H.postprocess_detections_pyramid = post
        H._write_and_evaluate = write
        cuda_build.launch = launch
        FR.proposal_layer = proposal
        del model.forward_test

    return restore
