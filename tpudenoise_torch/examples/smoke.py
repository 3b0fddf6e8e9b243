"""Library smoke of the PyTorch/CUDA port on the GPU: anchors -> RPN-style
decode -> clip -> NMS (`nms_fixpoint` and `nms_packed`: kernel 3 and the
walk) -> `make_pipeline` on one single-kind plan (sap_median_var0.4:
kernel 1), the counterpart of the JAX package's `examples/smoke.py`.

    python tpudenoise_torch/examples/smoke.py

The same steps run on the card and then on the CPU, where every kernel
wrapper takes its plain version; the card's kept boxes and noisy image
must equal the CPU's.  With no GPU it exits non-zero.
"""

import os.path as osp
import sys

import numpy as np
import torch

NOISE = 'sap_median_var0.4'


def steps(device) -> dict:
    """The smoke's steps on device: the two NMS keep sets over the top
    300 of 17100 decoded anchors, and the noisy (1, 120, 160, 3) image."""
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.noise.pipeline import make_pipeline
    from tpudenoise_torch.ops.anchors import anchor_grid, generate_anchors
    from tpudenoise_torch.ops.boxes import bbox_transform_inv, clip_boxes
    from tpudenoise_torch.ops.nms import nms_fixpoint, nms_packed

    assert generate_anchors().shape == (9, 4)
    anchors = anchor_grid(38, 50, 16, device=device)
    rng = np.random.RandomState(3)
    deltas = torch.from_numpy(rng.randn(anchors.shape[0], 4).astype(
        np.float32) * 0.1).to(device)
    hw = torch.tensor([600., 800.], device=device)
    boxes = clip_boxes(bbox_transform_inv(anchors, deltas), (hw[0], hw[1]))
    scores = torch.from_numpy(rng.rand(anchors.shape[0]).astype(
        np.float32)).to(device)
    top_scores, idx = torch.topk(scores, 300)
    sel, mask = nms_fixpoint(boxes[idx], top_scores, 0.7, max_outputs=100)
    selp, maskp = nms_packed(boxes[idx][None], top_scores[None], 0.7,
                             max_outputs=100)
    fn = make_pipeline(NOISE, mode='TEST')
    img = torch.from_numpy(rng.randint(0, 256, (1, 120, 160, 3)).astype(
        np.float32)).to(device)
    out = fn(prng.PRNGKey(0), img)
    return dict(anchors=anchors.shape[0], backend=fn.backend,
                fixpoint=idx[sel[mask].long()].cpu().tolist(),
                packed=idx[selp[maskp].long()].cpu().tolist(),
                image=out.cpu().numpy())


def main() -> int:
    if not torch.cuda.is_available():
        print('smoke: no CUDA device; this smoke runs only on a GPU',
              file=sys.stderr)
        return 1
    print('device:', torch.cuda.get_device_name(0))
    card, plain = steps('cuda'), steps('cpu')
    print('anchor grid:', card['anchors'])
    if card['packed'] != card['fixpoint']:
        raise AssertionError('nms_packed keeps other boxes than '
                             'nms_fixpoint on the card')
    if card['fixpoint'] != plain['fixpoint']:
        raise AssertionError('the card\'s NMS keeps other boxes than the '
                             'plain versions on the CPU')
    print('nms keep:', len(card['fixpoint']), 'of 300 (nms_packed, '
          'nms_fixpoint and the CPU\'s plain versions agree)')
    if not np.array_equal(card['image'], plain['image']):
        raise AssertionError(f'{NOISE}: the card\'s image differs from the '
                             f'plain version\'s')
    out = card['image']
    print('pipeline backend:', card['backend'], 'out', out.shape, out.dtype,
          float(out.min()), float(out.max()), '(equal to the CPU\'s)')
    print('SMOKE OK')
    return 0


if __name__ == '__main__':
    # run as a script: the repository root holds the package
    sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(
        osp.abspath(__file__)))))
    sys.exit(main())
