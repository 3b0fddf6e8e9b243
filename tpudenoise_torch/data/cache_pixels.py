"""Decode a dataset's JPEGs once into `.npy` pixels, on a host with cv2.

    python -m tpudenoise_torch.data.cache_pixels --imdb NAME
        [--data-dir DIR] [--out DIR]
    python -m tpudenoise_torch.data.cache_pixels [--image-set test]
        [--year 2021] [--data-dir DIR] [--out DIR]
    python -m tpudenoise_torch.data.cache_pixels --images [a.jpg ...]
        [--out DIR]

Each image of a registered dataset (--imdb: any name of
`data.factory.list_imdbs()`, VOC and COCO included; without it rrData's
--image-set and --year) goes through `cv2.imread` (the reader of the
reference's loop) into `<out>/<stem>.npy`, (H, W, 3) uint8 BGR, the stem
being the image's file name without extension; `<out>` defaults to
`build/pixels/<imdb name>` at the repository root, which git ignores and
a copy of the working tree keeps.  There `data.factory.get_imdb` finds
them, and the dataset loop reads those files on a machine without cv2 or
PIL, pixel for pixel what the reference reads.

With --images, the given files (default `data/demo/*.jpg`) are decoded
into `<out>/<stem>.npy`, `<out>` defaulting to `build/pixels/demo`, where
`python -m tpudenoise_torch.cli.demo` looks first.
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp

import numpy as np

from tpudenoise_torch.core.config import default_config
from tpudenoise_torch.data.voc_like import rrData
from tpudenoise_torch.utils.image_io import read_bgr


def default_pixel_dir(imdb_name: str, config=None) -> str:
    return osp.join((config or default_config()).ROOT_DIR, 'build',
                    'pixels', imdb_name)


def demo_pixel_dir(config=None) -> str:
    """Where the demo's cached pixels live: build/pixels/demo."""
    return default_pixel_dir('demo', config)


def cache_images(paths, out_dir: str) -> int:
    """Write each image file as out_dir/<stem>.npy; returns the number
    written."""
    os.makedirs(out_dir, exist_ok=True)
    for path in paths:
        stem = osp.splitext(osp.basename(path))[0]
        np.save(osp.join(out_dir, stem + '.npy'), read_bgr(path))
    return len(paths)


def cache(imdb_obj, out_dir: str) -> int:
    """Write every image of imdb_obj (a dataset without pixel_dir, so its
    JPEGs) as out_dir/<stem>.npy; returns the number written."""
    os.makedirs(out_dir, exist_ok=True)
    for i in range(imdb_obj.num_images):
        np.save(osp.join(out_dir, imdb_obj.image_stem_at(i) + '.npy'),
                read_bgr(imdb_obj.image_path_at(i)))
    return imdb_obj.num_images


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--imdb', default=None,
                    help='a registered dataset name (voc_2007_test, '
                         'coco_2014_minival, ...); default: rrData of '
                         '--image-set and --year')
    ap.add_argument('--image-set', default='test')
    ap.add_argument('--year', default='2021')
    ap.add_argument('--data-dir', default=None,
                    help='DATA_DIR (default: the config\'s, ROOT_DIR/data)')
    ap.add_argument('--out', default=None)
    ap.add_argument('--images', nargs='*', default=None,
                    help='decode these files instead of a dataset '
                         '(default with no file: data/demo/*.jpg)')
    args = ap.parse_args(argv)
    cfg = default_config()
    if args.images is not None:
        paths = args.images or sorted(glob.glob(
            osp.join(cfg.ROOT_DIR, 'data', 'demo', '*.jpg')))
        out = args.out or demo_pixel_dir(cfg)
        print(f'{cache_images(paths, out)} images cached in {out}')
        return 0
    if args.data_dir:
        cfg.DATA_DIR = osp.abspath(args.data_dir)
    if args.imdb:
        from tpudenoise_torch.data.factory import get_imdb
        d = get_imdb(args.imdb, cfg, pixels=False)
    else:
        d = rrData(args.image_set, args.year, config=cfg)
    out = args.out or default_pixel_dir(d.name, cfg)
    n = cache(d, out)
    print(f'{n} images of {d.name} cached in {out}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
