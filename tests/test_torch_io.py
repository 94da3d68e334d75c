"""climt_tpu_torch's IO layer and profiling hooks on the CPU: the native
NetCDF writer (io/native.py and its own io/_fastio.c, built under
climt_tpu_torch/_build/), the three monitors against the JAX package's,
and utils/profiling.py.  tests/test_io_native.py and
tests/test_utils.py:141-176 are mirrored here; the files are read back
with scipy's independent netCDF-3 reader.
"""

import datetime
import os
import struct
import sys

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import climt_tpu as jct
import climt_tpu_torch as tct
from climt_tpu.io import native as jnative
from climt_tpu.io.monitors import NetCDFMonitor as JNetCDFMonitor
from climt_tpu_torch.core.dataarray import DataArray
from climt_tpu_torch.io import native
from climt_tpu_torch.io.monitors import (NetCDFMonitor, PlotFunctionMonitor,
                                         RestartMonitor)
from climt_tpu_torch.utils import profiling

from torch_helpers import reset_port_registries


@pytest.fixture(autouse=True)
def _reset_registries():
    reset_port_registries()
    yield
    reset_port_registries()


def test_extension_builds_under_the_port_and_beside_jax():
    """The port's .so is built from its own source under
    climt_tpu_torch/_build/ and loaded as climt_tpu_torch.io._fastio,
    with the JAX package's extension loaded in the same process."""
    jax_module = jnative.load_fastio()
    module = native.load_fastio()
    assert module is not None, native._build_error
    assert module.__file__ == native.so_path()
    build_root = os.path.join(os.path.dirname(tct.__file__), '_build')
    assert os.path.commonpath([module.__file__, build_root]) == build_root
    assert native._SRC.startswith(os.path.dirname(tct.__file__))
    if jax_module is not None:
        assert module is not jax_module
        assert module.__file__ != jax_module.__file__
    assert sys.modules.get('climt_tpu_torch.io._fastio') is not jax_module


def test_header_matches_jax():
    dims = [('mid_levels', 4), ('lat', 3), ('lon', 5)]
    variables = [('air_temperature', ('mid_levels', 'lat', 'lon'), 'degK'),
                 ('surface_air_pressure', ('lat', 'lon'), 'Pa'),
                 ('q', ('mid_levels',), 'kg/kg')]
    assert native.build_header(dims, variables) == jnative.build_header(
        dims, variables)


# -- tests/test_io_native.py, mirrored --------------------------------------

def test_writer_roundtrip_scipy_readable(tmp_path):
    path = str(tmp_path / 'out.nc')
    rng = np.random.RandomState(0)
    fields = [rng.rand(4, 3) for _ in range(5)]
    w = native.AsyncNetCDFWriter(
        path, [('mid_levels', 4), ('lat', 3)],
        [('air_temperature', ('mid_levels', 'lat'), 'degK'),
         ('surface_air_pressure', ('lat',), 'Pa')])
    for i, f2d in enumerate(fields):
        w.append(10.0 * i, {'air_temperature': f2d,
                            'surface_air_pressure': f2d[0] * 1e5})
    assert w.close() == len(fields)
    f = netcdf_file(path, 'r', mmap=False)
    assert f.variables['time'].data.tolist() == [10.0 * i for i in range(5)]
    assert f.variables['air_temperature'].units == b'degK'
    assert f.variables['air_temperature'].dimensions == (
        'time', 'mid_levels', 'lat')
    np.testing.assert_array_equal(f.variables['air_temperature'].data,
                                  np.stack(fields))
    np.testing.assert_array_equal(
        f.variables['surface_air_pressure'].data,
        np.stack([f2d[0] * 1e5 for f2d in fields]))
    f.close()


def test_streaming_sentinel_then_finalized(tmp_path):
    path = str(tmp_path / 'stream.nc')
    w = native.AsyncNetCDFWriter(path, [('x', 2)], [('q', ('x',), 'kg')])
    header, recsize = native.build_header([('x', 2)], [('q', ('x',), 'kg')])
    w.append(0.0, {'q': np.arange(2.0)})
    w.append(1.0, {'q': np.arange(2.0) + 5})
    w.flush()
    with open(path, 'rb') as fh:
        raw = fh.read()
    assert struct.unpack('>I', raw[4:8])[0] == 0xFFFFFFFF
    assert len(raw) == len(header) + 2 * recsize
    w.close()
    with open(path, 'rb') as fh:
        assert struct.unpack('>I', fh.read(8)[4:8])[0] == 2
    f = netcdf_file(path, 'r', mmap=False)
    np.testing.assert_array_equal(f.variables['q'].data,
                                  [[0.0, 1.0], [5.0, 6.0]])
    f.close()


def test_record_size_mismatch_raises(tmp_path):
    w = native.AsyncNetCDFWriter(str(tmp_path / 'bad.nc'), [('x', 3)],
                                 [('q', ('x',), '')])
    with pytest.raises(ValueError):
        w.append(0.0, {'q': np.zeros(2)})
    w.close()


def _state(i, tensor=False):
    def values(x):
        return torch.as_tensor(x) if tensor else x

    return {
        'air_temperature': DataArray(
            values(270.0 + i + np.arange(12.0).reshape(3, 4)),
            ('mid_levels', 'lat'), {'units': 'degK'}, 'air_temperature'),
        'surface_air_pressure': DataArray(
            values(1e5 + i * np.ones(4)), ('lat',), {'units': 'Pa'},
            'surface_air_pressure'),
    }


def _read_all(path):
    f = netcdf_file(path, 'r', mmap=False)
    out = {name: (np.array(var.data), getattr(var, 'units', b''),
                  var.dimensions) for name, var in f.variables.items()}
    f.close()
    return out


def _assert_files_equal(a, b):
    assert set(a) == set(b)
    for name in a:
        np.testing.assert_array_equal(a[name][0], b[name][0], err_msg=name)
        if name != 'time':
            assert a[name][1:] == b[name][1:], name


@pytest.mark.parametrize('tensor', [False, True])
def test_monitor_native_matches_scipy(tmp_path, tensor):
    """The streaming and the buffered backend write equal files, from
    numpy or tensor states."""
    paths = [str(tmp_path / 'native.nc'), str(tmp_path / 'scipy.nc')]
    monitors = [NetCDFMonitor(paths[0], write_on_store=True,
                              backend='native'),
                NetCDFMonitor(paths[1], write_on_store=True,
                              backend='scipy')]
    for i in range(4):
        for m in monitors:
            m.store(_state(i, tensor))
    for m in monitors:
        m.close()
    _assert_files_equal(_read_all(paths[0]), _read_all(paths[1]))


def test_monitor_backend_auto_always_works(tmp_path):
    path = str(tmp_path / 'auto.nc')
    m = NetCDFMonitor(path, write_on_store=True)
    for i in range(3):
        m.store(_state(i))
    m.write()
    m.close()
    out = _read_all(path)
    assert out['air_temperature'][0].shape == (3, 3, 4)
    np.testing.assert_allclose(out['air_temperature'][0][2, 0, 0], 272.0)


def test_monitor_store_names_filter(tmp_path):
    path = str(tmp_path / 'filtered.nc')
    m = NetCDFMonitor(path, store_names=['surface_air_pressure'],
                      write_on_store=True)
    m.store(_state(0))
    m.close()
    out = _read_all(path)
    assert 'surface_air_pressure' in out and 'air_temperature' not in out


@pytest.mark.parametrize('backend', ['native', 'scipy'])
def test_store_after_close_raises_and_keeps_the_file(tmp_path, backend):
    """A departure from the JAX monitor, whose native store after close
    reopens the file and truncates it."""
    path = str(tmp_path / 'closed.nc')
    m = NetCDFMonitor(path, write_on_store=True, backend=backend)
    for i in range(2):
        m.store(_state(i))
    m.close()
    with pytest.raises(RuntimeError, match='after close'):
        m.store(_state(2))
    assert _read_all(path)['air_temperature'][0].shape == (2, 3, 4)


# -- the monitors against the JAX package's ---------------------------------

def _model_states(pkg, hours=(0, 1, 3)):
    """A Held-Suarez default state at 8x4x5 with a seeded temperature,
    at successive times."""
    state = pkg.get_default_state(
        [pkg.HeldSuarez(**({'device': 'cpu'} if pkg is tct else {}))],
        grid_state=pkg.get_grid(nx=8, ny=4, nz=5))
    rng = np.random.RandomState(1)
    T = 250.0 + 30.0 * rng.rand(*state['air_temperature'].shape)
    t0 = state['time']
    for k, hours_ in enumerate(hours):
        state['air_temperature'].values[:] = T + k
        state['time'] = t0 + datetime.timedelta(hours=hours_)
        yield state


@pytest.mark.parametrize('backend', ['native', 'scipy'])
def test_monitor_file_equals_the_jax_monitors(tmp_path, backend):
    """The same states through both packages' monitors give equal
    files; the port's states hold tensors."""
    paths = [str(tmp_path / 'port.nc'), str(tmp_path / 'jax.nc')]
    kw = dict(store_names=['air_temperature', 'surface_air_pressure',
                           'air_pressure_on_interface_levels'],
              write_on_store=True, backend=backend)
    monitors = [NetCDFMonitor(paths[0], **kw), JNetCDFMonitor(paths[1], **kw)]
    for st, sj in zip(_model_states(tct), _model_states(jct)):
        st = dict(st, air_temperature=st['air_temperature'].copy())
        st['air_temperature'].values = torch.as_tensor(
            st['air_temperature'].values)
        monitors[0].store(st)
        monitors[1].store(sj)
    for m in monitors:
        m.close()
    a, b = _read_all(paths[0]), _read_all(paths[1])
    _assert_files_equal(a, b)
    np.testing.assert_array_equal(a['time'][0], [0.0, 3600.0, 10800.0])


# -- tests/test_utils.py:141-176, mirrored ----------------------------------

def test_netcdf_monitor_roundtrip(tmp_path):
    path = str(tmp_path / 'out.nc')
    monitor = tct.NetCDFMonitor(path, store_names=['air_temperature'])
    state = tct.get_default_state(
        [tct.GrayLongwaveRadiation(device='cpu')],
        grid_state=tct.get_grid(nx=4, ny=3, nz=5))
    monitor.store(state)
    state['air_temperature'].values[:] += 1
    state['time'] += datetime.timedelta(hours=1)
    monitor.store(state)
    monitor.write()
    f = netcdf_file(path, 'r', mmap=False)
    T = np.array(f.variables['air_temperature'].data)
    assert T.shape == (2, 5, 3, 4)
    np.testing.assert_allclose(T[1] - T[0], 1.0)
    np.testing.assert_allclose(np.array(f.variables['time'].data),
                               [0., 3600.])
    f.close()


def test_restart_monitor_roundtrip(tmp_path):
    """A state holding tensors (after a component call) is stored and
    loaded back as numpy DataArrays, equal to the state's fields, which
    the next component call takes to its device again."""
    monitor = tct.RestartMonitor(str(tmp_path / 'restart'))
    hs = tct.HeldSuarez(device='cpu')
    state = tct.get_default_state([hs],
                                  grid_state=tct.get_grid(nx=4, ny=3, nz=5))
    state['air_temperature'].values = torch.as_tensor(
        state['air_temperature'].values + 1.5)
    monitor.store(state)
    loaded = monitor.load()
    assert isinstance(loaded['air_temperature'].values, np.ndarray)
    np.testing.assert_array_equal(loaded['air_temperature'].values,
                                  state['air_temperature'].values.numpy())
    assert loaded['air_temperature'].dims == state['air_temperature'].dims
    assert loaded['air_temperature'].units == state['air_temperature'].units
    assert loaded['time'] == state['time']
    tend, _ = hs(loaded)
    ref, _ = hs(state)
    assert torch.equal(tend['air_temperature'].values,
                       ref['air_temperature'].values)


def test_plot_monitor_gets_a_host_state(tmp_path):
    import matplotlib
    seen = []

    def plot(fig, state):
        seen.append(state)
        ax = fig.add_subplot(1, 1, 1)
        ax.plot(state['air_temperature'].values.flatten())
        fig.savefig(str(tmp_path / 'plot.png'))

    monitor = PlotFunctionMonitor(plot)
    state = _state(0, tensor=True)
    state['time'] = datetime.datetime(2000, 1, 1)
    monitor.store(state)
    assert isinstance(seen[0]['air_temperature'].values, np.ndarray)
    assert seen[0]['time'] == state['time']
    assert os.path.getsize(str(tmp_path / 'plot.png')) > 0
    if not os.environ.get('DISPLAY'):
        assert matplotlib.get_backend().lower() == 'agg'
    matplotlib.pyplot.close('all')


# -- utils/profiling.py -----------------------------------------------------

def test_phase_span_shows_in_a_cpu_profile(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.phase('dycore_step'):
            torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert 'dycore_step' in names
    with open(str(tmp_path / 'trace.json')) as fh:
        assert 'dycore_step' in fh.read()


def test_step_timer_counts():
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer:
            torch.ones(4).sum()
    assert len(timer.times) == 3
    assert timer.total_seconds >= 0.0
    assert timer.mean_seconds == pytest.approx(timer.total_seconds / 3)
    assert profiling.StepTimer().mean_seconds == 0.0
