"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source is compiled by its own ``nvcc`` for ``sm_90a``, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ``ctypes``.  The build
directory, ``climt_tpu_torch/_build/<hash>/``, is keyed by a hash of the
sources and flags, so an edit rebuilds.  Nothing here runs when the
package is imported: ``library()`` builds on its first call, which is the
first launch of a CUDA kernel.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, 'csrc')
BUILD_ROOT = os.path.join(_HERE, '_build')
ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']
NVCC_FLAGS = ARCH + ['-std=c++17', '-O3', '-Xcompiler', '-fPIC',
                     '-Xptxas', '-v']
LIB_NAME = 'libclimt_tpu_torch_kernels.so'
# flags of one source beside NVCC_FLAGS: emanuel.cu and taumol_terms.cu
# keep the plain versions' roundings, one per operation, so no product and
# sum may fuse
SOURCE_FLAGS = {'emanuel.cu': ['-fmad=false'],
                'taumol_terms.cu': ['-fmad=false']}

# filled by library(): build seconds (0.0 when the cached build was used),
# the library path and the compiler's log (ptxas register/spill report)
BUILD_INFO = {}
_LIB = []

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
SIGNATURES = {
    'climt_mix_groups_f32': [_P, _P, _I, _P, _P, _P, _L, _I, _P, _P],
    'climt_mix_groups_f64': [_P, _P, _I, _P, _P, _P, _L, _I, _P, _P],
    'climt_mix_groups_bwd_f32': [_P, _I, _P, _P, _P, _L, _I, _P, _P, _P],
    'climt_mix_groups_bwd_f64': [_P, _I, _P, _P, _P, _L, _I, _P, _P, _P],
    'climt_rtrn_lw_f32': [_P] * 10 + [_I, _I, _F] + [_P] * 5,
    'climt_emanuel_f32': [_P, _P, _I, _I, _I, _I, _P],
    'climt_emanuel_f64': [_P, _P, _I, _I, _I, _I, _P],
    'climt_taumol_terms_f32': [_P, _P, _P],
    'climt_taumol_terms_f64': [_P, _P, _P],
}


def sources():
    return sorted(glob.glob(os.path.join(CSRC, '*.cu'))
                  + glob.glob(os.path.join(CSRC, '*.cuh')))


def _nvcc():
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels are built with '
                       'the CUDA toolkit on a machine with a GPU')


def _digest(paths):
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for path in paths:
        h.update(os.path.basename(path).encode())
        with open(path, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library():
    """The loaded kernel library, built first if its hash is new."""
    if _LIB:
        return _LIB[0]
    srcs = sources()
    out_dir = os.path.join(BUILD_ROOT, _digest(srcs))
    so = os.path.join(out_dir, LIB_NAME)
    log = os.path.join(out_dir, 'build.log')
    seconds = 0.0
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        nvcc = _nvcc()
        tag = '%d.tmp' % os.getpid()
        t0 = time.perf_counter()
        jobs = []
        for src in (p for p in srcs if p.endswith('.cu')):
            obj = os.path.join(out_dir, '%s.%s.o' % (
                os.path.basename(src), tag))
            cmd = [nvcc] + NVCC_FLAGS + SOURCE_FLAGS.get(
                os.path.basename(src), []) + ['-c', '-o', obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        tmp = '%s.%s' % (so, tag)
        link = [nvcc] + ARCH + ['-shared', '-o', tmp] + [o for _, o, _ in jobs]
        text, failed = [], []
        for cmd, _, proc in jobs:
            out, err = proc.communicate()
            text.append(' '.join(cmd) + '\n' + out + err)
            if proc.returncode != 0:
                failed.append('%s (%d):\n%s' % (cmd[-1], proc.returncode,
                                                 err[-4000:]))
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            text.append(' '.join(link) + '\n' + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append('link (%d):\n%s' % (proc.returncode,
                                                  proc.stderr[-4000:]))
        for _, obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)
        seconds = time.perf_counter() - t0
        with open(log, 'w') as f:
            f.write('\n'.join(text))
        if failed:
            raise RuntimeError('nvcc failed: ' + '\n'.join(failed))
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    BUILD_INFO.update(seconds=seconds, path=so, log=(
        open(log).read() if os.path.exists(log) else ''))
    _LIB.append(lib)
    return lib


def check_launch(rc, name):
    if rc != 0:
        raise RuntimeError('%s: CUDA launch failed with error %d' % (
            name, rc))
