"""BENCHMARK.json's cells, configurations, traffic mixes and metrics are
found by name, and agree with the files that hold them."""

import json
import os.path as osp
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['portbench']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize('w', BENCH['workloads'], ids=lambda w: w['name'])
def test_cell_finds_its_files(w):
    c = spec.cell(w['name'])
    assert c['config']['name'] == w['config']
    assert c['traffic']['name'] == w['traffic']
    assert NAME.match(w['name']) and len(w['why']) <= 200
    from portbench import check
    assert set(check.NUMBERS) <= set(c['limits'])
    assert c['limits']['noise_off'] == 0
    names = {m['name'] for m in c['end_to_end']}
    assert 'setup_s' in names and len(names) >= 2
    assert c['per_layer']


@pytest.mark.parametrize('c', BENCH['configs'], ids=lambda c: c['name'])
def test_config_file(c):
    assert c['file'] == f'portbench/configs/{c["name"]}.json'
    conf = spec.config(c['name'])
    assert conf['source'] == c['source'] and conf['reduced'] == c['reduced']


@pytest.mark.parametrize('name', sorted({w['traffic']
                                         for w in BENCH['workloads']}))
def test_traffic_file(name):
    t = spec.traffic(name)
    assert t['rows'] and t['images'] > 0 and t['eval_batch'] > 0


@pytest.mark.parametrize('m', BENCH['per_layer'], ids=lambda m: m['name'])
def test_metric_reader(m):
    assert callable(spec.metric(m['name']).read)
    assert m['layer'] and m['unit']
    assert m['moves'] in {e['name'] for e in BENCH['end_to_end']}


def test_unknown_kernel_has_no_count():
    assert spec.kernel('no_such_entry') is None
    assert spec.kernel('suppression_masks') is not None


def test_names_are_unique():
    for key in ('configs', 'workloads'):
        names = [x['name'] for x in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert len(metrics) == len(set(metrics))
    assert all(osp.exists(osp.join(spec.ROOT, c['file']))
               for c in BENCH['configs'])
