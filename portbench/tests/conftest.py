"""Shared pieces of the benchmark's tests: a cell cut to a size the CPU
holds (the program's plain versions run there), and the `cuda` marker's
fixture, which decides at run time whether a card is present."""

import os.path as osp
import sys

import pytest

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_cell(workload: str = 'res101.sap_median') -> dict:
    """The cell at 4 images of 64x96, batch 2, RPN 600 -> 30: the same
    code paths at a CPU's size."""
    from portbench import spec
    c = spec.cell(workload)
    c['config'].update(test_scales=[64], test_max_size=96, bucket=[64, 96],
                       rpn_pre_nms_top_n=600, rpn_post_nms_top_n=30)
    c['traffic'].update(images=4, image_hw=[64, 96], eval_batch=2,
                        check_rows=len(c['traffic']['rows']))
    return c


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: run on the card with '
                    '`python -m pytest portbench/tests -m cuda`')
    return torch.device('cuda', 0)
