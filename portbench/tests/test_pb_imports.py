"""The run refuses the JAX stack and the JAX package by whole top-level
names; nothing under portbench imports them, and the reference imports
nothing of the program."""

import ast
import glob
import os.path as osp

import pytest

from portbench import harness, spec


@pytest.mark.parametrize('names,found', [
    (['jax', 'jax.numpy', 'numpy'], ['jax']),
    (['jaxlib.xla_client'], ['jaxlib']),
    (['flax.linen'], ['flax']),
    (['tpudenoise', 'tpudenoise.noise.pipeline'], ['tpudenoise']),
    (['tpudenoise_torch', 'tpudenoise_torch.eval.harness', 'torch'], []),
    (['jaxtyping', 'flaxen'], []),
])
def test_refused_top_level_names(names, found):
    assert harness.refused(names) == found


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split('.')[0]


def _files(sub=''):
    return sorted(glob.glob(osp.join(spec.HERE, sub, '**', '*.py'),
                            recursive=True))


@pytest.mark.parametrize('path', _files(), ids=lambda p: osp.relpath(
    p, spec.HERE))
def test_no_jax_stack(path):
    assert not set(_imports(path)) & set(harness.REFUSED)


@pytest.mark.parametrize('path', _files('reference'),
                         ids=lambda p: osp.relpath(p, spec.HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert 'tpudenoise_torch' not in set(_imports(path))
