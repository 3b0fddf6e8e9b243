"""Dataset name -> constructor registry (counterpart of
`tpudenoise/data/factory.py`), with the same names: rrData_2021_{train,
val,trainval,test}, voc_{2007,2012}_{train,val,trainval,test} and the
coco_2014/2015 splits.

Each dataset reads `.npy` pixels from `cache_pixels.default_pixel_dir(name,
config)` when that directory holds every image of the set (as `python -m
tpudenoise_torch.data.cache_pixels --imdb NAME` writes it on a host with
cv2), else its JPEGs, which `utils.image_io.read_bgr` decodes through cv2
(absent on the GPU machine).
"""

from __future__ import annotations

import os.path as osp

from tpudenoise_torch.core.config import cfg as default_cfg
from tpudenoise_torch.data.cache_pixels import default_pixel_dir
from tpudenoise_torch.data.coco import coco
from tpudenoise_torch.data.voc_like import pascal_voc, rrData

# name -> (config, pixel_dir) -> dataset
__sets = {}

for year in ['2007', '2012']:
    for split in ['train', 'val', 'trainval', 'test']:
        __sets[f'voc_{year}_{split}'] = (
            lambda config, pdir, split=split, year=year: pascal_voc(
                split, year, config=config, pixel_dir=pdir))

for year in ['2021']:
    for split in ['train', 'val', 'trainval', 'test']:
        __sets[f'rrData_{year}_{split}'] = (
            lambda config, pdir, split=split, year=year: rrData(
                split, year, config=config, pixel_dir=pdir))

for year, splits in (('2014', ['train', 'val', 'minival',
                               'valminusminival']),
                     ('2015', ['test', 'test-dev'])):
    for split in splits:
        __sets[f'coco_{year}_{split}'] = (
            lambda config, pdir, split=split, year=year: coco(
                split, year, config=config, pixel_dir=pdir))


def get_imdb(name: str, config=None, pixels: bool = True):
    """The dataset `name`, built with `config` (default: the module-level
    `cfg` of `core/config.py`, which the CLIs overlay); with pixels, on
    its cached `.npy` pixels when every image has one."""
    if name not in __sets:
        raise KeyError(f'Unknown dataset: {name}. '
                       f'Known: {sorted(__sets)}')
    config = config or default_cfg
    d = __sets[name](config, None)
    pdir = default_pixel_dir(d.name, config)
    if pixels and all(osp.exists(osp.join(pdir, d.image_stem_at(i) + '.npy'))
                      for i in range(d.num_images)):
        d = __sets[name](config, pdir)
    return d


def list_imdbs():
    return sorted(__sets)
