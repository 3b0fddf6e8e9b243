"""Dataset name -> constructor registry (counterpart of
`tpudenoise/data/factory.py`), with the same names: rrData_2021_{train,
val,trainval,test}, voc_{2007,2012}_{train,val,trainval,test} and the
coco_2014/2015 splits.

rrData reads `.npy` pixels from `cache_pixels.default_pixel_dir(name,
config)` when that directory holds every image of the set (as `python -m
tpudenoise_torch.data.cache_pixels` writes it on a host with cv2), else
its JPEGs, which `utils.image_io.read_bgr` decodes through cv2 (absent on
the GPU machine).  pascal_voc and COCO are not ported yet: their names
raise NotImplementedError naming ROADMAP Queue 1 item 18.
"""

from __future__ import annotations

import os.path as osp

from tpudenoise_torch.core.config import cfg as default_cfg
from tpudenoise_torch.data.cache_pixels import default_pixel_dir
from tpudenoise_torch.data.voc_like import rrData

__sets = {}


def _rrdata(split: str, year: str, config):
    d = rrData(split, year, config=config)
    pdir = default_pixel_dir(d.name, config)
    if all(osp.exists(osp.join(pdir, index + '.npy'))
           for index in d.image_index):
        d = rrData(split, year, config=config, pixel_dir=pdir)
    return d


def _not_ported(name: str, what: str):
    def make(config):
        raise NotImplementedError(
            f'{name}: {what} is not ported yet (ROADMAP Queue 1 item 18)')
    return make


for year in ['2021']:
    for split in ['train', 'val', 'trainval', 'test']:
        __sets[f'rrData_{year}_{split}'] = (
            lambda config, split=split, year=year: _rrdata(split, year,
                                                           config))

for year in ['2007', '2012']:
    for split in ['train', 'val', 'trainval', 'test']:
        name = f'voc_{year}_{split}'
        __sets[name] = _not_ported(name, 'pascal_voc')

for year, splits in (('2014', ['train', 'val', 'minival',
                               'valminusminival']),
                     ('2015', ['test', 'test-dev'])):
    for split in splits:
        name = f'coco_{year}_{split}'
        __sets[name] = _not_ported(name, 'COCO')


def get_imdb(name: str, config=None):
    """The dataset `name`, built with `config` (default: the module-level
    `cfg` of `core/config.py`, which the CLIs overlay)."""
    if name not in __sets:
        raise KeyError(f'Unknown dataset: {name}. '
                       f'Known: {sorted(__sets)}')
    return __sets[name](config or default_cfg)


def list_imdbs():
    return sorted(__sets)
