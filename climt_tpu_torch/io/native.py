"""Native async NetCDF writer: build and load of the ``_fastio`` C
extension (climt_tpu/io/native.py).

``io/_fastio.c`` owns the record-append data path (a writer pthread,
byte-swapped GIL-free appends); this module owns the cold metadata path:

- building the extension with the system C compiler at first use, into
  ``climt_tpu_torch/_build/fastio-<source hash>/`` (never beside the
  source), and loading it by path under the dotted name
  ``climt_tpu_torch.io._fastio``, so that it never collides with another
  package's top-level ``_fastio`` in the same process;
- the NetCDF classic (CDF-2, 64-bit offset) header for a fixed schema of
  f8 record variables, with numrecs=STREAMING so that a crash mid-run
  leaves a well-defined file (``close`` finalizes it).

``AsyncNetCDFWriter`` is the user-facing class; ``NetCDFMonitor``
(io/monitors.py) streams through it.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import struct
import subprocess
import sysconfig

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, '_fastio.c')
BUILD_ROOT = os.path.join(os.path.dirname(_HERE), '_build')
MODULE_NAME = 'climt_tpu_torch.io._fastio'

NC_DIMENSION = 0x0A
NC_VARIABLE = 0x0B
NC_ATTRIBUTE = 0x0C
NC_CHAR = 2
NC_DOUBLE = 6
STREAMING = 0xFFFFFFFF

_module = None
_build_error = None


def so_path():
    """Where the extension of the current ``_fastio.c`` is built."""
    with open(_SRC, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    suffix = sysconfig.get_config_var('EXT_SUFFIX') or '.so'
    return os.path.join(BUILD_ROOT, 'fastio-' + digest, '_fastio' + suffix)


def _build():
    so = so_path()
    if os.path.exists(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = '%s.%d.tmp' % (so, os.getpid())
    cc = (sysconfig.get_config_var('CC') or 'cc').split()
    include = sysconfig.get_paths()['include']
    subprocess.run(cc + ['-O2', '-fPIC', '-shared', '-pthread',
                         '-I' + include, _SRC, '-o', tmp],
                   check=True, capture_output=True)
    os.replace(tmp, so)              # atomic: concurrent builds agree
    return so


def load_fastio():
    """The C extension, built at first use.  Returns the module, or None
    when it cannot be built (no C compiler); ``NetCDFMonitor`` then falls
    back to the scipy writer under backend='auto' and raises under
    backend='native'."""
    global _module, _build_error
    if _module is not None or _build_error is not None:
        return _module
    try:
        so = _build()
        loader = importlib.machinery.ExtensionFileLoader(MODULE_NAME, so)
        spec = importlib.util.spec_from_file_location(MODULE_NAME, so,
                                                      loader=loader)
        module = importlib.util.module_from_spec(spec)
        loader.exec_module(module)
        _module = module
    except (OSError, subprocess.CalledProcessError, ImportError) as exc:
        _build_error = exc
    return _module


def _pad4(b):
    return b + b'\x00' * ((4 - len(b) % 4) % 4)


def _name(s):
    b = s.encode()
    return struct.pack('>I', len(b)) + _pad4(b)


def build_header(dims, variables):
    """NetCDF CDF-2 header for f8 record variables (native.py:90).

    Args:
      dims: list of (name, size) for the fixed dimensions, in id order;
        the record dimension 'time' (size 0) is prepended.
      variables: list of (name, dim_names, units); each is a record
        variable of doubles with dims ('time',) + dim_names.  'time'
        itself comes first, with units 'seconds since start'.
    Returns:
      (header_bytes, record_size_bytes)
    """
    all_dims = [('time', 0)] + list(dims)
    dim_ids = {n: i for i, (n, _) in enumerate(all_dims)}
    dim_sizes = dict(all_dims)

    out = [b'CDF\x02', struct.pack('>I', STREAMING)]
    out.append(struct.pack('>II', NC_DIMENSION, len(all_dims)))
    for n, size in all_dims:
        out.append(_name(n) + struct.pack('>I', size))
    out.append(struct.pack('>II', 0, 0))        # no global attributes

    all_vars = ([('time', (), 'seconds since start')]
                + [(n, tuple(dn), u) for n, dn, u in variables])
    out.append(struct.pack('>II', NC_VARIABLE, len(all_vars)))

    vsizes = []                                 # doubles: no padding
    for _, dnames, _ in all_vars:
        count = 1
        for d in dnames:
            count *= dim_sizes[d]
        vsizes.append(count * 8)

    def var_entry(n, dnames, units, vsize, begin):
        dids = ('time',) + dnames
        ub = units.encode() if isinstance(units, str) else bytes(units)
        return b''.join(
            [_name(n), struct.pack('>I', len(dids))]
            + [struct.pack('>I', dim_ids[d]) for d in dids]
            + [struct.pack('>II', NC_ATTRIBUTE, 1), _name('units'),
               struct.pack('>II', NC_CHAR, len(ub)), _pad4(ub),
               struct.pack('>I', NC_DOUBLE), struct.pack('>I', vsize),
               struct.pack('>Q', begin)])       # CDF-2: 64-bit begin

    # the header's size places the data: measure it with begin 0 first
    header_size = sum(len(b) for b in out) + sum(
        len(var_entry(n, d, u, vs, 0))
        for (n, d, u), vs in zip(all_vars, vsizes))
    begins = header_size + np.concatenate([[0], np.cumsum(vsizes)[:-1]])
    final = b''.join(var_entry(n, d, u, vs, int(bg)) for (n, d, u), vs, bg
                     in zip(all_vars, vsizes, begins))
    return b''.join(out) + final, sum(vsizes)


class AsyncNetCDFWriter:
    """Streaming record appender over the ``_fastio`` extension.

    One ``append`` per model store hands the record to the C writer
    thread and returns; ``flush`` blocks until everything queued is on
    disk; ``close`` finalizes numrecs in the header.
    """

    def __init__(self, filename, dims, variables):
        fastio = load_fastio()
        if fastio is None:
            raise RuntimeError(
                'native writer unavailable: {}'.format(_build_error))
        self._fastio = fastio
        header, self.record_size = build_header(dims, variables)
        self._var_names = [n for n, _, _ in variables]
        self._handle = fastio.open(filename, header)
        self.records = 0

    def append(self, time_seconds, fields):
        """fields: {name: host array} matching the declared schema."""
        parts = [np.asarray([time_seconds], '=f8').tobytes()]
        for n in self._var_names:
            parts.append(np.ascontiguousarray(
                fields[n], dtype='=f8').tobytes())
        rec = b''.join(parts)
        # record_size counts the leading time scalar's 8 bytes too
        if len(rec) != self.record_size:
            raise ValueError('record size mismatch: got {} expected {}'
                             .format(len(rec), self.record_size))
        self._fastio.append(self._handle, rec)
        self.records += 1

    def flush(self):
        return self._fastio.flush(self._handle)

    def close(self):
        if self._handle is not None:
            n = self._fastio.close(self._handle)
            self._handle = None
            return n
