"""Monitors: model output to NetCDF files, live plots and restart files
(climt_tpu/io/monitors.py).

``NetCDFMonitor`` (``store_names`` filtering, ``write_on_store``
appending, the scipy and native writers), ``PlotFunctionMonitor`` (a
user function drawing on a matplotlib figure) and ``RestartMonitor`` (an
.npz and a JSON sidecar).  A stored state may live on the card: each
stored field is copied to the host once, at ``store``.

Unlike the JAX monitor, ``NetCDFMonitor.store`` after ``close`` raises
instead of reopening and truncating the file.
"""

from __future__ import annotations

import datetime
import json
import os

import numpy as np

from ..core.dataarray import DataArray, to_numpy


class NetCDFMonitor:
    """Accumulates states and writes them to a NetCDF file.

    Args:
        filename: output path.
        store_names: optional iterable restricting which quantities are
            stored.
        write_on_store: if True, every store lands on disk before the
            next model step.
        time_units: units string for the time axis.
        backend: 'auto' (default), 'native' or 'scipy'.  With
            ``write_on_store`` the 'native' backend streams each record
            through the ``_fastio`` C extension (io/native.py); the scipy
            path rewrites the whole file per store.  'auto' takes the
            native writer when the extension builds and scipy otherwise;
            'native' raises when it is unavailable.
    """

    def __init__(self, filename, store_names=None, write_on_store=False,
                 time_units='seconds', backend='auto'):
        if backend not in ('auto', 'native', 'scipy'):
            raise ValueError('backend must be auto|native|scipy')
        self._filename = filename
        self._store_names = set(store_names) if store_names else None
        self._write_on_store = write_on_store
        self._time_units = time_units
        self._backend = backend
        self._snapshots = []
        self._reference_time = None
        self._writer = None         # AsyncNetCDFWriter once streaming
        self._count = 0
        self._closed = False

    def _want_native(self):
        return self._write_on_store and self._backend in ('auto', 'native')

    def _open_native(self, snapshot):
        """Fix the schema from the first snapshot and open the streaming
        writer; returns False, with the scipy writer arranged, when the
        extension is unavailable under backend='auto'."""
        from .native import AsyncNetCDFWriter
        dim_sizes = {}
        variables = []
        for name, (arr, dims, units) in snapshot.items():
            for d, s in zip(dims, arr.shape):
                if dim_sizes.setdefault(d, s) != s:
                    raise ValueError(
                        'dimension {!r} has conflicting sizes'.format(d))
            variables.append((name, tuple(dims), units))
        try:
            self._writer = AsyncNetCDFWriter(
                self._filename, list(dim_sizes.items()), variables)
        except RuntimeError:
            if self._backend == 'native':
                raise
            self._backend = 'scipy'
            return False
        return True

    def store(self, state):
        if self._closed:
            raise RuntimeError('NetCDFMonitor.store after close: {} is '
                               'finalized'.format(self._filename))
        time = state.get('time')
        if self._reference_time is None:
            self._reference_time = time
        snapshot = {}
        for name, value in state.items():
            if name == 'time':
                continue
            if self._store_names and name not in self._store_names:
                continue
            if isinstance(value, DataArray):
                arr = to_numpy(value.values)      # one copy off the card
                if arr.dtype.kind in 'fiu':
                    snapshot[name] = (arr.copy(), value.dims, value.units)
        if isinstance(time, datetime.datetime) and isinstance(
                self._reference_time, datetime.datetime):
            seconds = (time - self._reference_time).total_seconds()
        else:
            seconds = float(self._count)
        self._count += 1
        if self._want_native() and (self._writer is not None
                                    or self._open_native(snapshot)):
            self._writer.append(
                seconds, {n: a for n, (a, _, _) in snapshot.items()})
            return
        self._snapshots.append((seconds, snapshot))
        if self._write_on_store:
            self.write()

    def write(self):
        """Flush everything stored so far to disk: the native writer
        blocks until its queue is drained, the scipy writer rewrites the
        file with every snapshot."""
        if self._writer is not None:
            self._writer.flush()
            return
        from scipy.io import netcdf_file
        if not self._snapshots:
            return
        f = netcdf_file(self._filename, 'w', mmap=False)
        try:
            f.createDimension('time', len(self._snapshots))
            times = f.createVariable('time', 'd', ('time',))
            times[:] = [s for s, _ in self._snapshots]
            times.units = 'seconds since start'

            first = self._snapshots[0][1]
            dim_sizes = {}
            for arr, dims, _ in first.values():
                for d, s in zip(dims, arr.shape):
                    dim_sizes.setdefault(d, s)
            for d, s in dim_sizes.items():
                f.createDimension(d, s)
            for name, (_, dims, units) in first.items():
                var = f.createVariable(name, 'd', ('time',) + tuple(dims))
                var[:] = np.stack(
                    [snap[name][0] for _, snap in self._snapshots])
                var.units = units.encode() if isinstance(units, str) \
                    else units
        finally:
            f.close()

    def close(self):
        """Finalize the file: the native writer patches the record count
        (the STREAMING sentinel while open), the buffered scipy writer
        writes a last time.  Later stores raise."""
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        elif not self._write_on_store:
            self.write()
        self._closed = True


class PlotFunctionMonitor:
    """Calls a user plotting function with (figure, state) on store.

    Works headless (the Agg backend) when no display is available.  The
    function gets a host copy of the state (every DataArray's values as
    a numpy array), so it draws a state that lives on the card too.
    """

    def __init__(self, plot_function, interactive=True):
        import matplotlib
        if not os.environ.get('DISPLAY'):
            matplotlib.use('Agg')
            interactive = False
        import matplotlib.pyplot as plt
        self._plt = plt
        self._plot_function = plot_function
        self._interactive = interactive
        if interactive:
            plt.ion()
        self._figure = plt.figure()

    def store(self, state):
        host = {name: DataArray(to_numpy(value.values), value.dims,
                                value.attrs, value.name)
                if isinstance(value, DataArray) else value
                for name, value in state.items()}
        self._figure.clear()
        self._plot_function(self._figure, host)
        if self._interactive:
            self._figure.canvas.draw()
            self._plt.pause(0.001)


class RestartMonitor:
    """Checkpoint and resume of the full model state: the arrays as an
    .npz and their dims, units and the time in a JSON sidecar.  ``load``
    gives numpy-backed DataArrays, which move to a component's device at
    its next call."""

    def __init__(self, filename):
        self._filename = filename

    def store(self, state):
        arrays = {}
        meta = {}
        for name, value in state.items():
            if name == 'time':
                if isinstance(value, datetime.datetime):
                    meta['time'] = value.isoformat()
                continue
            if isinstance(value, DataArray):
                arrays[name] = to_numpy(value.values)
                meta[name] = {'dims': list(value.dims),
                              'units': value.units}
        np.savez(self._filename, **arrays)
        with open(self._filename + '.meta.json', 'w') as fh:
            json.dump(meta, fh)

    def load(self):
        path = self._filename
        if not path.endswith('.npz'):
            path = path + '.npz'
        with open(self._filename + '.meta.json') as fh:
            meta = json.load(fh)
        state = {}
        with np.load(path, allow_pickle=False) as data:
            for name in data.files:
                info = meta[name]
                state[name] = DataArray(data[name], tuple(info['dims']),
                                        {'units': info['units']}, name)
        if 'time' in meta:
            state['time'] = datetime.datetime.fromisoformat(meta['time'])
        return state
