"""roidb preparation for training (counterpart of `tpudenoise/data/
roidb.py`): image path and size, max-overlap stats and the noise string
stamped into every entry; flips; the filter of entries with neither fg
nor bg; and the '+'-joined multi-dataset roidb.  A merged roidb (the gt
rows, then the rpn proposals of `TRAIN.PROPOSAL_METHOD` 'rpn') goes
through the same steps: its proposal rows join the max-overlap stats and
so the filter, and the loader keeps only its gt rows (gt_classes != 0).

Image sizes come from `utils.image_io.image_hw` (the `.npy` header, or
PIL for a JPEG, imported only then): the GPU machine has no PIL.
"""

from __future__ import annotations

import numpy as np

from tpudenoise_torch.core.config import cfg as default_cfg
from tpudenoise_torch.utils.image_io import image_hw


def prepare_roidb(imdb_obj, noise: str):
    """Enrich the roidb entries in place with image path and size, max
    overlap stats and the noise type."""
    roidb = imdb_obj.roidb
    sizes = [image_hw(imdb_obj.image_path_at(i))
             for i in range(imdb_obj.num_images)]
    for i in range(len(imdb_obj.image_index)):
        roidb[i]['img_id'] = i
        roidb[i]['image'] = imdb_obj.image_path_at(i)
        roidb[i]['height'], roidb[i]['width'] = sizes[i]
        gt_overlaps = np.asarray(roidb[i]['gt_overlaps'])
        if gt_overlaps.size:
            max_overlaps = gt_overlaps.max(axis=1)
            max_classes = gt_overlaps.argmax(axis=1)
            assert all(max_classes[max_overlaps == 0] == 0)
            assert all(max_classes[max_overlaps > 0] != 0)
        else:
            max_overlaps = np.zeros((0,))
            max_classes = np.zeros((0,), np.int64)
        roidb[i]['max_classes'] = max_classes
        roidb[i]['max_overlaps'] = max_overlaps
        roidb[i]['noise_type'] = noise


def get_training_roidb(imdb_obj, noise: str, config=None):
    """Flip (TRAIN.USE_FLIPPED) and prepare."""
    C = config or default_cfg
    if C.TRAIN.USE_FLIPPED:
        print('Appending horizontally-flipped training examples...')
        imdb_obj.append_flipped_images()
    prepare_roidb(imdb_obj, noise)
    return imdb_obj.roidb


def filter_roidb(roidb, config=None):
    """Drop the entries with neither fg nor bg RoIs in range."""
    C = config or default_cfg

    def is_valid(entry):
        overlaps = entry['max_overlaps']
        fg = overlaps >= C.TRAIN.FG_THRESH
        bg = (overlaps < C.TRAIN.BG_THRESH_HI) & (
            overlaps >= C.TRAIN.BG_THRESH_LO)
        return bool(fg.any() or bg.any())

    num = len(roidb)
    filtered = [e for e in roidb if is_valid(e)]
    print(f'Filtered {num - len(filtered)} roidb entries: '
          f'{num} -> {len(filtered)}')
    return filtered


class CombinedImdb:
    """The dataset handle of a '+'-joined roidb: its name and classes."""

    def __init__(self, name: str, classes):
        self.name = name
        self.classes = list(classes)

    @property
    def num_classes(self):
        return len(self.classes)


def combined_roidb(imdb_names: str, noise: str, config=None,
                   training: bool = True, device='cuda'):
    """(dataset, roidb) of one name or of '+'-joined names (their roidbs
    concatenated, the first's classes); a proposal method's overlaps run
    on device."""
    from tpudenoise_torch.data.factory import get_imdb
    C = config or default_cfg

    def get_roidb(name):
        obj = get_imdb(name, C)
        print(f'Loaded dataset `{obj.name}`')
        obj.device = device
        obj.set_proposal_method(C.TRAIN.PROPOSAL_METHOD)
        if training:
            return obj, get_training_roidb(obj, noise, C)
        prepare_roidb(obj, noise)
        return obj, obj.roidb

    pairs = [get_roidb(s) for s in imdb_names.split('+')]
    roidb = pairs[0][1]
    if len(pairs) == 1:
        return pairs[0][0], roidb
    for _, r in pairs[1:]:
        roidb.extend(r)
    return CombinedImdb(imdb_names, pairs[0][0].classes), roidb
