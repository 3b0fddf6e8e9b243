"""Demo CLI on the GPU (counterpart of `tpudenoise/cli/demo.py`): noise,
detection and box rendering on a few images.

    python -m tpudenoise_torch.cli.demo [--net res101] [--model w.npz]
        [--images a.npy b.jpg ...] [--noise gaussian_gaus_blur_var0.1]
        [--conf 0.8] [--out sheet.ppm] [--device cuda|cpu] [--profile DIR]

Images are read by `utils.image_io.read_bgr`: `.npy` pixels with numpy,
anything else through cv2 (absent on the GPU machine).  With no
--images, the demo reads `build/pixels/demo/*.npy` (written from
`data/demo/*.jpg` on a host with cv2 by `python -m
tpudenoise_torch.data.cache_pixels --images`), else `data/demo/*.jpg`.
Each image runs `detect_chunk`'s two steps one image a batch: its
`fold_in` key and the noise (`noise_chunk`), then device prep at the
600/1000 geometry into its orientation's bucket, the forward and the
per-class NMS (`detect_noisy`).  Boxes at or above --conf are drawn as
2-px red outlines with numpy and listed on stdout (no cv2 to write text);
the panels, side by side, are written as a binary PPM for `--out *.ppm`,
else as `.npy`.
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp

import numpy as np

from tpudenoise_torch.cli.test import NETS, load_params, resolve_device

# the JAX demo's prep geometry (its `preprocess` defaults), not cfg.TEST
TARGET_SIZE, MAX_SIZE = 600, 1000
RED = (0, 0, 255)                     # BGR


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Faster R-CNN demo (PyTorch/'
                                            'CUDA port)')
    p.add_argument('--net', default='res101', choices=NETS)
    p.add_argument('--model', default=None,
                   help='.npz weights (random if unset)')
    p.add_argument('--images', nargs='*', default=None,
                   help='.npy (H, W, 3) uint8 BGR pixels, or files cv2 '
                        'reads where it is installed')
    p.add_argument('--noise', default='original')
    p.add_argument('--classes', nargs='*', default=None,
                   help='class names; default VOC-21')
    p.add_argument('--conf', type=float, default=0.8)
    p.add_argument('--out', default='output.png',
                   help='the sheet: a binary PPM for *.ppm, else .npy '
                        '(output.png writes output.npy: no PNG writer '
                        'without cv2 or PIL)')
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                   help='where the demo runs (default cuda; no fallback)')
    p.add_argument('--profile', default=None, metavar='DIR',
                   help='write a torch.profiler Chrome trace into DIR')
    return p.parse_args(argv)


def default_images(config) -> list:
    """build/pixels/demo/*.npy when cached, else data/demo/*.jpg."""
    from tpudenoise_torch.data.cache_pixels import demo_pixel_dir
    cached = sorted(glob.glob(osp.join(demo_pixel_dir(config), '*.npy')))
    return cached or sorted(glob.glob(osp.join(config.ROOT_DIR, 'data',
                                               'demo', '*.jpg')))


def draw_box(img: np.ndarray, box, color=RED, width: int = 2):
    """A width-px outline of box (x1, y1, x2, y2), inclusive, clipped to
    the image, in place."""
    h, w = img.shape[:2]
    x1, y1, x2, y2 = (int(v) for v in box)
    x1, x2 = max(0, min(x1, w - 1)), max(0, min(x2, w - 1))
    y1, y2 = max(0, min(y1, h - 1)), max(0, min(y2, h - 1))
    img[y1:y1 + width, x1:x2 + 1] = color
    img[max(y1, y2 - width + 1):y2 + 1, x1:x2 + 1] = color
    img[y1:y2 + 1, x1:x1 + width] = color
    img[y1:y2 + 1, max(x1, x2 - width + 1):x2 + 1] = color


def write_sheet(sheet: np.ndarray, out: str) -> str:
    """Write the BGR sheet as a binary PPM (RGB) for *.ppm, else as .npy;
    returns the path written."""
    if out.endswith('.ppm'):
        h, w = sheet.shape[:2]
        with open(out, 'wb') as f:
            f.write(f'P6\n{w} {h}\n255\n'.encode('ascii'))
            f.write(np.ascontiguousarray(sheet[..., ::-1]).tobytes())
        return out
    path = out if out.endswith('.npy') else osp.splitext(out)[0] + '.npy'
    np.save(path, sheet)
    return path


def read_ppm(path: str) -> np.ndarray:
    """The (H, W, 3) uint8 BGR sheet of a binary PPM that write_sheet
    wrote."""
    with open(path, 'rb') as f:
        data = f.read()
    magic, w, h, maxval, pixels = data.split(maxsplit=4)
    assert magic == b'P6' and maxval == b'255', path
    rgb = np.frombuffer(pixels, np.uint8).reshape(int(h), int(w), 3)
    return rgb[..., ::-1].copy()


def image_geometry(im: np.ndarray, device):
    """The (1, 5) geom row (h0, w0, oh, ow, scale) of im at the demo's
    600/1000 geometry, and its orientation's bucket."""
    import torch
    from tpudenoise_torch.utils.blob import derive_bucket, rescale_geometry
    h0, w0 = im.shape[:2]
    s, oh, ow = rescale_geometry(h0, w0, TARGET_SIZE, MAX_SIZE)
    geom = torch.tensor([(h0, w0, oh, ow, s)], dtype=torch.float32,
                        device=device)
    return geom, derive_bucket(TARGET_SIZE, MAX_SIZE, portrait=h0 > w0)


def main(argv=None):
    """Runs the demo; returns one dict per image (path, noisy shape, the
    per-class boxes/scores/mask) and the sheet's path under 'out'."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    import torch
    from tpudenoise_torch.core import prng
    from tpudenoise_torch.core.config import cfg
    from tpudenoise_torch.data.voc_like import VOC_CLASSES
    from tpudenoise_torch.eval.harness import (detect_noisy, noise_chunk,
                                               set_matmul_precision)
    from tpudenoise_torch.models.faster_rcnn import FasterRCNN
    from tpudenoise_torch.noise.pipeline import make_pipeline
    from tpudenoise_torch.utils.image_io import read_bgr
    from tpudenoise_torch.utils.profiling import trace

    classes = args.classes or list(VOC_CLASSES)
    model = FasterRCNN(backbone=args.net, num_classes=len(classes),
                       anchor_scales=tuple(cfg.ANCHOR_SCALES),
                       anchor_ratios=tuple(cfg.ANCHOR_RATIOS), cfg=cfg)
    params, _ = load_params(model, args.model, args.net,
                            torch.Generator().manual_seed(cfg.RNG_SEED))
    model.to(device)
    params = {k: v.to(device) for k, v in params.items()}
    set_matmul_precision()

    paths = args.images or default_images(cfg)
    if not paths:
        raise SystemExit('no images: pass --images, or keep data/demo/*.jpg '
                         '(or their .npy from cache_pixels --images)')
    noise_fn = make_pipeline(args.noise, mode='TEST')
    key = prng.PRNGKey(cfg.RNG_SEED)

    panels, results = [], []
    with trace(args.profile):
        for idx, path in enumerate(paths):
            im = read_bgr(path)
            geom, bucket = image_geometry(im, device)
            noisy = noise_chunk(key, [idx], torch.from_numpy(im)[None].to(
                device), noise_fn)
            bx, sc, mk = (t[0].cpu().numpy() for t in detect_noisy(
                model, params, noisy, [(geom, bucket)]))
            vis = np.clip(noisy[0].float().cpu().numpy(), 0, 255).astype(
                np.uint8)
            n_drawn = 0
            for c in range(1, len(classes)):
                sel = mk[c - 1] & (sc[c - 1] >= args.conf)
                for b, s in zip(bx[c - 1][sel], sc[c - 1][sel]):
                    draw_box(vis, b)
                    print(f'{path}: {classes[c]} {s:.2f} at '
                          f'({", ".join(str(int(v)) for v in b)})')
                    n_drawn += 1
            print(f'{path}: {n_drawn} detections >= {args.conf}')
            panels.append(vis)
            results.append(dict(path=path, shape=im.shape, boxes=bx,
                                scores=sc, mask=mk))
    h = max(p.shape[0] for p in panels)
    sheet = np.zeros((h, sum(p.shape[1] for p in panels), 3), np.uint8)
    x = 0
    for p in panels:
        sheet[:p.shape[0], x:x + p.shape[1]] = p
        x += p.shape[1]
    out = write_sheet(sheet, args.out)
    print(f'Saved {out}')
    return dict(images=results, out=out, sheet_shape=sheet.shape)


if __name__ == '__main__':
    main()
