"""Nothing that the benchmark runs loads JAX or the JAX package, and the
plain reference loads nothing of the program.  Module names are
compared by their whole top-level name: the program's ``climt_tpu_torch``
begins with the JAX package's name and must not be caught."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from gcmbench import harness

HARNESS = ['gcmbench.run', 'gcmbench.harness', 'gcmbench.tracing',
           'gcmbench.compare', 'gcmbench.costs.gcm', 'gcmbench.costs.rrtmg',
           'gcmbench.drivers.gcm', 'gcmbench.drivers.rad',
           'gcmbench.tools.calibrate']
REFERENCE = ['gcmbench.reference.gcm', 'gcmbench.reference.lw',
             'gcmbench.reference.sw', 'gcmbench.reference.dynamics']
CODE = r'''
import importlib, sys
for name in sys.argv[2:]:
    importlib.import_module(name)
{extra}
print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))
'''


def top_level_names(modules, extra=''):
    out = subprocess.run(
        [sys.executable, '-c', CODE.format(extra=extra), 'x'] + modules,
        cwd=harness.ROOT, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_whole_name_check_passes_for_the_port():
    import types
    saved = dict(sys.modules)
    try:
        sys.modules['climt_tpu_torch_probe'] = types.ModuleType('p')
        assert 'climt_tpu' not in harness.forbidden_modules()
        sys.modules['climt_tpu.probe'] = types.ModuleType('p')
        assert 'climt_tpu' in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_harness_drivers_metrics_and_reference_load_no_jax():
    readers = sorted(os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(harness.HERE, 'metrics', '*.py')))
    extra = ('from gcmbench import harness\n'
             'from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm\n'
             + ''.join("harness.load_module('metrics', %r)\n" % r
                       for r in readers))
    names = top_level_names(HARNESS + REFERENCE, extra)
    assert 'climt_tpu_torch' in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = top_level_names(REFERENCE)
    assert not names & (set(harness.FORBIDDEN) | {'climt_tpu_torch'})


@pytest.mark.parametrize('path', sorted(glob.glob(os.path.join(
    harness.HERE, 'reference', '*.py'))), ids=os.path.basename)
def test_reference_sources_import_only_torch_numpy_and_itself(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split('.')[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                continue
            tops = [node.module.split('.')[0]]
        else:
            continue
        assert set(tops) <= {'__future__', 'contextlib', 'functools',
                             'math', 'os', 'numpy', 'torch'}, tops
