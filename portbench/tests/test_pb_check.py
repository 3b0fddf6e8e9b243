"""What decides `correct`, driven through the rest of a run (the chip's
look skipped, a small cell on the CPU): a sound run passes; the timed
path broken underneath fails it, once for each fault an evaluation cell
can have (half of the batch left out; an answer altered where it is
produced); the control fails it.  The control at the cell's own size is
a `cuda` test."""

import time

import pytest
import torch

from portbench import check, harness, spec, weights
from portbench.tests.conftest import tiny_cell

CPU = torch.device('cpu')


def _run(c, seed=2**31 + 101, trace=False):
    return harness.run(c, seed, 0.1, trace, CPU, time.perf_counter())


def test_sound_run_is_correct():
    r = _run(tiny_cell())
    assert r['correct'], r['checks']
    assert list(r) == ['correct', 'attempted', 'failed', 'metrics',
                       'device', 'checks']
    assert set(r['metrics']) == {'setup_s', 'img_per_s', 'row_s_p90'}
    assert all(v['value'] > 0 for v in r['metrics'].values())


def _half_batch(monkeypatch):
    from tpudenoise_torch.eval import harness as H
    post = H.postprocess_detections_pyramid

    def half(*a, **k):
        boxes, scores, mask = post(*a, **k)
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = False
        return boxes, scores, mask

    monkeypatch.setattr(H, 'postprocess_detections_pyramid', half)


def _noise_altered(monkeypatch):
    from tpudenoise_torch.eval import harness as H
    noise = H.noise_chunk

    def altered(*a, **k):
        out = noise(*a, **k).clone()
        out[0, 10, 10, 0] = (out[0, 10, 10, 0] + 128) % 256
        return out

    monkeypatch.setattr(H, 'noise_chunk', altered)


def _score_altered(monkeypatch):
    from tpudenoise_torch.eval import harness as H
    post = H.postprocess_detections_pyramid

    def altered(*a, **k):
        boxes, scores, mask = post(*a, **k)
        return boxes, scores * 0.999, mask

    monkeypatch.setattr(H, 'postprocess_detections_pyramid', altered)


@pytest.mark.parametrize('fault', [_half_batch, _noise_altered,
                                   _score_altered])
def test_fault_fails(fault, monkeypatch):
    fault(monkeypatch)
    r = _run(tiny_cell())
    assert not r['correct'], r['checks']


def test_control_fails(tmp_path):
    c = tiny_cell()
    with torch.no_grad():
        cell = harness.Cell(c['config'], c['traffic'], 7, CPU, str(tmp_path))
    cell.free_program()
    from portbench.readings import chunks_of
    sd = weights.make(cell.layout, 7, CPU)
    ctl = check.control_chunks(chunks_of(cell), cell.ds, sd, c['config'],
                               CPU)
    numbers = check.judge(ctl, cell.ds, sd, c['config'], CPU)
    ok, _ = check.verdict(numbers, c['limits'])
    assert not ok, numbers


def test_traced_run_reads_the_layers():
    r = _run(tiny_cell(), trace=True)
    assert r['correct'], r['checks']
    m = r['metrics']
    for name in ('evaluate_ms', 'noise_host_ms', 'forward_host_ms',
                 'mfu_pct'):
        assert m[name]['value'] > 0
    assert 'kernel_roofline_pct' not in m      # no kernel runs on a CPU
    assert r['device']['window_s'] > 0
    assert len(r['breakdown']['idle_gaps']) <= 10


@pytest.mark.cuda
@pytest.mark.parametrize('workload', [w['name'] for w in
                                      spec.benchmark()['workloads']])
def test_control_fails_at_cell_size(card, workload):
    from portbench.readings import one
    c = spec.cell(workload)
    numbers = one(c, 2**31 + 5, 'control', card)['numbers']
    ok, _ = check.verdict(numbers, c['limits'])
    assert not ok, numbers
