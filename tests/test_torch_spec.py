"""The port's own copy of the noise grammar (`tpudenoise_torch.noise.spec`)
against the JAX package's, field by field: every noise string of
RESULTS.md, each mix key, `curvelet` and an unknown string, in TEST and
TRAIN mode, strict and not."""

import tests.torch_threads  # noqa: F401  (torch threads per xdist worker)
import os.path as osp
import re

import pytest

import tpudenoise.noise.spec as jspec
import tpudenoise_torch.noise.spec as tspec

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _results_strings():
    with open(osp.join(REPO, 'RESULTS.md')) as f:
        rows = re.findall(r'^\| ([a-z0-9_.]+)(?: \(control[^|]*\))? \|',
                          f.read(), re.M)
    return sorted(set(rows) - {'noise'})


STRINGS = (_results_strings()
           + [f'noise_mix_{k}' for k in ('var_low', 'var_medium', 'var_high',
                                         'var_all')]
           + ['noise_mix_var_all_bilateral', 'noise_mix_var_medium_median',
              'curvelet', 'definitely_not_a_noise', '', 'sap_var0.3'])


def _fields(plan):
    return ([(int(s.kind), s.kind.name, s.level, int(s.denoise),
              s.denoise.name, s.unit_float_output, s.is_random_level)
             for s in plan.specs],
            int(plan.post_denoise), plan.post_denoise.name, plan.raw)


def test_results_strings_found():
    got = _results_strings()
    assert len(got) >= 40 and 'speckle_bilateral_var1.0' in got


@pytest.mark.parametrize('mode', ['TEST', 'TRAIN'])
@pytest.mark.parametrize('strict', [False, True])
def test_parse_matches_jax(mode, strict):
    for s in STRINGS:
        want = jspec.parse(s, mode=mode, strict_ref=strict)
        got = tspec.parse(s, mode=mode, strict_ref=strict)
        assert _fields(got) == _fields(want), s


def test_tables_match_jax():
    for name in ('TEST_MIX', 'TRAIN_MIX', 'CURVELET_MIX',
                 'GAUSSIAN_RANDOM_LEVELS'):
        assert getattr(tspec, name) == getattr(jspec, name), name
    assert ({int(k): v for k, v in tspec.LEVELS.items()}
            == {int(k): v for k, v in jspec.LEVELS.items()})
    assert [(k.name, int(k)) for k in tspec.Kind] == \
        [(k.name, int(k)) for k in jspec.Kind]
    assert [(k.name, int(k)) for k in tspec.Denoise] == \
        [(k.name, int(k)) for k in jspec.Denoise]
