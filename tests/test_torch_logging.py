"""The port's metrics logger and profiling hooks against the JAX
package's (`tpudenoise_torch.utils.logging` / `profiling` beside
`tpudenoise.utils.logging`).

The same calls go to both loggers: the stdout lines and the JSONL
records (but their `_time`) must be equal, the TensorBoard event files
must hold the same scalars, histograms and images, and a stand-in wandb
module must see the same calls.  The port's `trace` writes a Chrome trace
that holds the regions `annotate` names.
"""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import glob
import json
import sys
import types

import numpy as np
import pytest

STEPS = [({'loss': 0.25, 'lr': 1e-3, 'iter': 7}, 3), ({'ap': 0.5}, None)]


def _loggers(kw):
    """JAX's and the port's logger, each built with kw(its name)."""
    from tpudenoise.utils.logging import MetricsLogger as JLogger
    from tpudenoise_torch.utils.logging import MetricsLogger as TLogger
    return JLogger(**kw('jax')), TLogger(**kw('torch'))


def _drive(logger):
    """One of each call a logger takes."""
    rng = np.random.RandomState(0)
    for metrics, step in STEPS:
        logger.log(metrics, step=step)
    logger.log_histogram('SCORE/cls', rng.normal(size=(4, 5)), step=2)
    logger.log_histogram('SCORE/empty', np.zeros((0,)), step=2)
    logger.log_scalar_quiet('score', 0.9, step=4)
    logger.log_image('GT/im', rng.randint(0, 256, (6, 8, 3)).astype(
        np.uint8), step=1)
    logger.flush()
    logger.close()


def test_stdout_and_jsonl_match_jax(tmp_path, capsys):
    loggers = _loggers(lambda who: dict(logdir=str(tmp_path / who)))
    out = []
    for logger in loggers:
        _drive(logger)
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and '[step 3] loss=0.25 lr=0.001 iter=7' in out[0]
    recs = []
    for who in ('jax', 'torch'):
        with open(tmp_path / who / 'metrics.jsonl') as f:
            recs.append([json.loads(line) for line in f])
    for rec in recs[0] + recs[1]:
        assert rec.pop('_time') > 0
    assert recs[0] == recs[1] == [{'loss': 0.25, 'lr': 1e-3, 'iter': 7,
                                   '_step': 3}, {'ap': 0.5}]


def _events(path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    acc = EventAccumulator(str(path), size_guidance={'images': 0,
                                                     'histograms': 0,
                                                     'scalars': 0})
    acc.Reload()
    return acc


def test_tensorboard_events_match_jax(tmp_path):
    """Scalars, histograms (the empty one dropped) and images."""
    for logger in _loggers(lambda who: dict(tb_dir=str(tmp_path / who),
                                            quiet=True)):
        assert logger.active_sinks
        _drive(logger)
    jax_ev, port_ev = _events(tmp_path / 'jax'), _events(tmp_path / 'torch')
    tags = jax_ev.Tags()
    assert tags['scalars'] == port_ev.Tags()['scalars']
    assert sorted(tags['scalars']) == ['ap', 'iter', 'loss', 'lr', 'score']
    assert tags['histograms'] == port_ev.Tags()['histograms'] == ['SCORE/cls']
    assert tags['images'] == port_ev.Tags()['images'] == ['GT/im']
    for tag in tags['scalars']:
        assert ([(s.step, s.value) for s in jax_ev.Scalars(tag)]
                == [(s.step, s.value) for s in port_ev.Scalars(tag)])
    (hj,), (hp,) = jax_ev.Histograms('SCORE/cls'), port_ev.Histograms(
        'SCORE/cls')
    assert hj.step == hp.step == 2 and hj.histogram_value == \
        hp.histogram_value
    (ij,), (ip,) = jax_ev.Images('GT/im'), port_ev.Images('GT/im')
    assert (ij.step, ij.width, ij.height, ij.encoded_image_string) == (
        ip.step, ip.width, ip.height, ip.encoded_image_string)
    assert (ij.width, ij.height) == (8, 6)


@pytest.fixture
def fake_wandb(monkeypatch):
    """A stand-in wandb module that records every call."""
    calls = []
    mod = types.ModuleType('wandb')
    mod.init = lambda **kw: calls.append(('init', kw))
    mod.log = lambda data, step=None: calls.append(('log', data, step))
    mod.Histogram = lambda v: ('Histogram', np.asarray(v).tolist())
    mod.Image = lambda im: ('Image', np.asarray(im).tolist())
    monkeypatch.setitem(sys.modules, 'wandb', mod)
    return calls


def test_wandb_calls_match_jax(fake_wandb):
    loggers = _loggers(lambda who: dict(project='p', quiet=True))
    assert fake_wandb == [('init', {'project': 'p'})] * 2
    seen = []
    for logger in loggers:
        assert logger.active_sinks
        fake_wandb.clear()
        _drive(logger)
        seen.append(list(fake_wandb))
    assert seen[0] == seen[1]
    assert [c[0] for c in seen[0]] == ['log'] * 5
    # the quiet scalar carries no step (wandb wants steps non-decreasing)
    assert ('log', {'score': 0.9}, None) in seen[0]


def test_no_sink_without_tb_or_wandb_matches_jax():
    from tpudenoise.utils.logging import get_metrics_logger as jget
    from tpudenoise_torch.utils.logging import (MetricsLogger,
                                                get_metrics_logger,
                                                set_metrics_logger)
    assert get_metrics_logger().active_sinks is jget().active_sinks is False
    prev = get_metrics_logger()
    mine = MetricsLogger(quiet=True)
    set_metrics_logger(mine)
    try:
        assert get_metrics_logger() is mine
    finally:
        set_metrics_logger(prev)


def test_trace_holds_annotated_regions(tmp_path, capsys):
    import torch
    from tpudenoise_torch.utils.profiling import annotate, trace
    with trace(str(tmp_path)):
        with annotate('noise_stage'):
            torch.ones(64).cumsum(0)
    (path,) = glob.glob(str(tmp_path / '*.json'))
    assert f'trace written to {path}' in capsys.readouterr().out
    with open(path) as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == 'noise_stage' for e in events)
    with trace(None):                       # no logdir: no profiler
        pass
    assert glob.glob(str(tmp_path / '*.json')) == [path]
