"""What decides `correct`: the outputs of the timed rows, held against
the plain reference (`reference/`), at the timed sizes.

A sample of the window's chunks, drawn from the seed (`sample`), is
kept while the rows run: each chunk's noisy frames, the RPN's outputs,
the detector's outputs and the detections collected into detections.pkl.  Once the
window has closed and the program is freed, the reference works each
chunk out again from the raw frames, the weights and the row's eval key,
and five numbers are compared, each with the limit its file states
(the traffic's for the noise, the configuration's for the rest):

* `noise_off`: noisy values off the reference's by more than one u8
  level (1/255 for a plan whose output stays in unit floats), a count;
* `rpn_err`: the RPN's outputs of every anchor, the larger of two: the
  objectness scores' RMS gap over the reference's RMS; the box deltas'
  RMS gap over the RMS of the terms each delta sums (|W| |x| + |b|);
* `roi_miss`: the share of proposal slots that differ (by more than
  1e-3 pixel, or kept on one side only) between the program's rois and
  the reference's proposal layer run on the program's own RPN outputs;
* `head_err`: the class logits and box deltas at the program's own rois,
  the RMS of the gap over the RMS of the terms each output sums, the
  larger of the two (an output that is a small difference of large terms,
  as random heads give on some seeds, would read its rounding many times
  over against its own RMS);
* `det_miss`: the share of detections that differ (box by more than
  1e-3 pixel or score by more than 1e-6) between detections.pkl and the
  reference's detections of the program's detector outputs.

`roi_miss`, `head_err` and `det_miss` follow the program one stage on
from its own outputs (its RPN outputs, its rois, its detector outputs):
the proposals' top-k and NMS, like the detections' NMS, turn on near-ties
that any change of rounding reorders, so the reference's own proposals
are no fixed target.  `rpn_err`, `roi_miss` and `head_err` check those
starting outputs by themselves.

Two more readings, in 'drift' and compared with no limit, show how far
the staged comparison drifts from the reference's own path end to end:
`own_roi_miss`, the share of proposals of either side with no proposal
of the same image on the other at IoU 0.7 (the RPN's NMS threshold) or
more, the reference's from its own RPN outputs; and
`own_det_miss`, the share of detections of either side with no
detection of the same class on the other at IoU 0.5 or more, the
reference's taken from its own proposals through its own heads.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from portbench import dataset as D
from portbench.reference import detector as R
from portbench.reference import postprocess as RP
from portbench.reference.arith import Arith
from portbench.reference.noise import pipeline as RN
from portbench.reference.noise import prng as RK
from portbench.reference.noise.spec import Denoise, Kind, parse

NUMBERS = ('noise_off', 'rpn_err', 'roi_miss', 'head_err', 'det_miss')
BOX_TOL, SCORE_TOL = 1e-3, 1e-6


def row_seed(seed: int, r: int) -> int:
    """Row r's cfg.RNG_SEED: seed * 1000 + r, in the 32 bits a PRNGKey
    takes."""
    return (int(seed) * 1000 + r) % 2**32


def sample(seed: int, n_strings: int, n_rows: int, n_chunks: int) -> dict:
    """{row: chunk} to compare: n_rows rows, each string of the mix in
    turn, each from one of its first three cycles, and one chunk of each,
    all drawn from the seed."""
    rng = random.Random(int(seed) * 7919 + 17)
    out = {}
    for j in range(n_rows):
        cycle = 3 * (j // n_strings) + rng.randrange(3)
        out[cycle * n_strings + j % n_strings] = rng.randrange(n_chunks)
    return out


def _unit_output(noise: str) -> bool:
    plan = parse(noise, mode='TEST')
    return (len(plan.specs) == 1 and plan.post_denoise == Denoise.NONE
            and plan.specs[0].kind == Kind.GAUSSIAN
            and plan.specs[0].denoise == Denoise.NONE
            and plan.specs[0].unit_float_output)


def ref_noise(raw_u8: torch.Tensor, noise: str, rng_seed: int, idx):
    keys = RK.fold_in(RK.PRNGKey(rng_seed), np.asarray(idx))
    return RN.make_pipeline(noise, mode='TEST').keyed(keys, raw_u8)


def ref_backbone(sd, net: str, noisy, cfg: dict, A: Arith):
    """The reference's features, im_info and RPN outputs of a chunk."""
    imgs, info = R.prep(noisy, cfg['pixel_means'], cfg['test_scales'][0],
                        cfg['test_max_size'], cfg['bucket'], A)
    feat = R.head(sd, net, imgs.permute(0, 3, 1, 2), A)
    scores, deltas, fh, fw, terms = R.rpn(sd, feat, A)
    return feat, info, scores, deltas, (fh, fw), terms


def rms(t) -> float:
    return float(t.pow(2).mean().sqrt())


def rel_err(got, want, scale=None) -> float:
    """RMS of the gap over the RMS of scale (of the reference when
    None)."""
    return rms(got - want) / max(rms(want if scale is None else scale),
                                 1e-30)


def box_diff(rois, mask, ref_rois, ref_mask) -> tuple:
    """(positions that differ, positions kept by either side): the same
    proposals in the same order, within BOX_TOL pixels."""
    both = mask & ref_mask
    far = (rois - ref_rois).abs().amax(-1) > BOX_TOL
    return (int((mask ^ ref_mask).sum() + (both & far).sum()),
            int((mask | ref_mask).sum()))


def det_diff(got: list, want: list) -> tuple:
    """(unmatched rows of both, rows of both) over one image's classes."""
    bad = total = 0
    for g, w in zip(got, want):
        total += len(g) + len(w)
        if len(g) == 0 or len(w) == 0:
            bad += len(g) + len(w)
            continue
        d = np.abs(g[:, None, :4] - w[None, :, :4]).max(-1)
        s = np.abs(g[:, None, 4] - w[None, :, 4])
        ok = (d <= BOX_TOL) & (s <= SCORE_TOL)
        used, matched = set(), 0
        for i in range(len(g)):
            for j in np.nonzero(ok[i])[0]:
                if j not in used:
                    used.add(int(j))
                    matched += 1
                    break
        bad += len(g) + len(w) - 2 * matched
    return bad, total


def iou_miss(got: list, want: list, thr: float = 0.5) -> tuple:
    """(unmatched rows of both, rows of both) over one image's classes:
    each row of got, by score, takes the first free row of want at IoU
    thr or more (boxes in pixels, +1 areas as the detections')."""
    bad = total = 0
    for g, w in zip(got, want):
        total += len(g) + len(w)
        if len(g) == 0 or len(w) == 0:
            bad += len(g) + len(w)
            continue
        g = g[np.argsort(-g[:, 4], kind='stable')]
        lt = np.maximum(g[:, None, :2], w[None, :, :2])
        rb = np.minimum(g[:, None, 2:4], w[None, :, 2:4])
        inter = np.prod(np.clip(rb - lt + 1, 0, None), -1)

        def area(b):
            return (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)

        iou = inter / (area(g)[:, None] + area(w)[None] - inter)
        free = np.ones(len(w), bool)
        for i in range(len(g)):
            ok = np.nonzero(free & (iou[i] >= thr))[0]
            if len(ok):
                free[ok[0]] = False
        bad += len(g) + len(w) - 2 * int((~free).sum())
    return bad, total


def f32_exact() -> None:
    """Float32 matmuls and convs without TF32 (PyTorch's cuDNN default
    allows it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def warm(ds: dict, sd: dict, cfg: dict, c: dict, device, A: Arith):
    """One throwaway pass of the reference's network over a chunk.  On
    the card the first float32 call of a cuDNN conv at some shapes reads
    far off float64 (16% at the RPN's 3x3 conv, 16 x 1024 x 38 x 64;
    1.2e-6 from the second call on), so every shape runs once before
    the reference is read."""
    raw = torch.from_numpy(D.frames(ds, c['idx'])).to(device)
    feat, info, scores, deltas, fhw, _ = ref_backbone(sd, cfg['net'],
                                                      raw.float(), cfg, A)
    rois, mask = R.proposals(scores, deltas, *fhw, info, cfg, A)
    R.heads(sd, cfg['net'], feat, rois, cfg['num_classes'], cfg, A)


def judge(chunks: list, ds: dict, sd: dict, cfg: dict, device) -> dict:
    """The numbers over the sampled chunks.  chunks: dicts with 'noise',
    'rng_seed', 'idx', 'noisy', 'rpn' (scores, deltas), 'fwd' (rois,
    roi_mask, cls_score, bbox_pred, cls_prob, im_info) and 'dets' (per
    image, per foreground class, (n, 5)) of the side judged."""
    f32_exact()
    A = Arith('f32')
    net = cfg['net']
    if chunks:
        with torch.no_grad():
            warm(ds, sd, cfg, chunks[0], device, A)
    noise_off, parts = 0, {}
    roi, det, own_roi, own_det = [0, 0], [0, 0], [0, 0], [0, 0]

    def worst(name, v):
        parts[name] = max(parts.get(name, 0.0), v)

    with torch.no_grad():
        for c in chunks:
            raw = torch.from_numpy(D.frames(ds, c['idx'])).to(device)
            want = ref_noise(raw, c['noise'], c['rng_seed'], c['idx'])
            level = 1.0 / 255.0 if _unit_output(c['noise']) else 1.0
            noise_off += int(((c['noisy'].to(device) - want).abs()
                              > level * 1.0001).sum())
            feat, info, scores, deltas, fhw, terms = ref_backbone(
                sd, net, want, cfg, A)
            p = {k: v.to(device) for k, v in c['rpn'].items()}
            worst('rpn_scores', rel_err(p['scores'], scores))
            worst('rpn_deltas', rel_err(p['deltas'], deltas, terms))
            f = {k: v.to(device) for k, v in c['fwd'].items()}
            rois, mask = R.proposals(p['scores'], p['deltas'], *fhw,
                                     f['im_info'], cfg, A)
            d, t = box_diff(f['rois'], f['roi_mask'], rois, mask)
            roi[0] += d
            roi[1] += t
            n_cls = f['cls_score'].shape[-1]
            score, delta, tail = R.heads(sd, net, feat, f['rois'], n_cls,
                                         cfg, A)
            sel = f['roi_mask']
            t_cls, t_box = R.head_terms(sd, tail[sel], n_cls)
            worst('head_cls', rel_err(f['cls_score'][sel], score[sel], t_cls))
            worst('head_box', rel_err(f['bbox_pred'][sel], delta[sel], t_box))
            # the look: how far each output cancels its own terms
            for k, ref, t in (('cancel_cls', score[sel], t_cls),
                              ('cancel_box', delta[sel], t_box)):
                parts[k] = min(parts.get(k, 1.0), rel_err(ref, 0 * ref, t))
            dets = RP.detections(f['rois'], f['roi_mask'], f['cls_prob'],
                                 f['bbox_pred'], f['im_info'], cfg, A)
            for got, ref in zip(c['dets'], dets):
                b, t = det_diff(got, ref)
                det[0] += b
                det[1] += t
            # the drift: the reference's own path end to end
            rois, mask = R.proposals(scores, deltas, *fhw, info, cfg, A)
            for i in range(rois.shape[0]):
                _add(own_roi, iou_miss([_ranked(f['rois'][i],
                                                f['roi_mask'][i])],
                                       [_ranked(rois[i], mask[i])], 0.7))
            score, delta, _ = R.heads(sd, net, feat, rois, n_cls, cfg, A)
            own = RP.detections(rois, mask, torch.softmax(score, -1), delta,
                                info, cfg, A)
            for got, ref in zip(c['dets'], own):
                _add(own_det, iou_miss(got, ref))
            del feat, want, raw
    return {'noise_off': noise_off,
            'rpn_err': max(parts['rpn_scores'], parts['rpn_deltas']),
            'roi_miss': roi[0] / max(roi[1], 1),
            'head_err': max(parts['head_cls'], parts['head_box']),
            'det_miss': det[0] / max(det[1], 1), 'parts': parts,
            'drift': {'own_roi_miss': own_roi[0] / max(own_roi[1], 1),
                      'own_det_miss': own_det[0] / max(own_det[1], 1)}}


def _ranked(rois, mask) -> np.ndarray:
    """The kept proposals as (n, 5) rows (box, minus the slot: the
    proposal layer's order as the score)."""
    b = rois[mask].double().cpu().numpy()
    return np.hstack([b, -np.arange(len(b), dtype=np.float64)[:, None]])


def _add(acc: list, pair: tuple) -> None:
    acc[0] += pair[0]
    acc[1] += pair[1]


def control_chunks(samples: list, ds: dict, sd: dict, cfg: dict,
                   device) -> list:
    """The control's side: the reference put in the program's place, one
    step below each stage's stated precision (`reference/arith.py`),
    over the same chunks."""
    f32_exact()
    A = Arith('control')
    net = cfg['net']
    out = []
    with torch.no_grad():
        warm(ds, sd, cfg, samples[0], device, A)
        for c in samples:
            raw = torch.from_numpy(D.frames(ds, c['idx'])).to(device)
            noisy = ref_noise(raw, c['noise'], c['rng_seed'], c['idx'])
            feat, info, scores, deltas, fhw, _ = ref_backbone(
                sd, net, noisy, cfg, A)
            rois, mask = R.proposals(scores, deltas, *fhw, info, cfg, A)
            score, delta, _ = R.heads(sd, net, feat, rois,
                                      cfg['num_classes'], cfg, A)
            prob = torch.softmax(score, -1)
            fwd = {'rois': rois, 'roi_mask': mask, 'cls_score': score,
                   'bbox_pred': delta, 'cls_prob': prob, 'im_info': info}
            dets = RP.detections(rois, mask, prob, delta, info, cfg, A)
            out.append(dict(c, noisy=noisy, fwd=fwd, dets=dets,
                            rpn={'scores': scores, 'deltas': deltas}))
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its
    limit."""
    rows = [(k, numbers[k], limits[k]) for k in NUMBERS]
    return all(v <= lim for _, v, lim in rows), rows
