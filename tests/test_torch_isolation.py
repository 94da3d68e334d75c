"""climt_tpu_torch imports neither jax nor the JAX package: every module of
the port, found with ``pkgutil.walk_packages``, is imported in a fresh
interpreter, which then holds no ``jax``, ``jaxlib`` or ``climt_tpu``
module."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import importlib, json, pkgutil, sys
import climt_tpu_torch
names = ['climt_tpu_torch'] + [
    m.name for m in pkgutil.walk_packages(climt_tpu_torch.__path__,
                                          'climt_tpu_torch.')]
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules
          if m.split('.')[0] in ('jax', 'jaxlib', 'climt_tpu')]
print(json.dumps({'imported': names, 'forbidden': loaded}))
'''


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in os.environ.get(
                       'PYTHONPATH', '').split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, '-c', SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['forbidden'] == []
    # the walk reached every subpackage, the CORK component and the LW
    # k-table tools among them
    for name in ('climt_tpu_torch.components.cork.lw',
                 'climt_tpu_torch.components.rrtmg.lw_surrogate',
                 'climt_tpu_torch.tools.calibrate_lw_ktables',
                 'climt_tpu_torch.tools.build_lw_surrogate_ktables',
                 'climt_tpu_torch.entry_points',
                 'climt_tpu_torch.parallel.rep_sht',
                 'climt_tpu_torch.io.native', 'climt_tpu_torch.ops.sht'):
        assert name in result['imported']
