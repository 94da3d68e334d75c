"""Geographical boundary-condition components, LandMask and DataOcean
(climt_tpu/components/geodata.py).

The data files (``data.LAND_MASK``, ``data.TOPOGRAPHY``, ``data.SST``)
are read once, and the setup work stays on the host with numpy and
scipy: the nearest-neighbour indices of the land mask, the nearest-valid
fill of the SST source (a cKDTree), the mid-month solve, and the four
corner indices and weights of each bilinear map (linear extrapolation at
the edges, as scipy's ``RegularGridInterpolator(fill_value=None)`` that
JAX calls per call).  They are made at the first call and kept for the
component's grid.  Per call, DataOcean blends the two mid-month SST
corner fields and the corners on ``device``.  ``area_type`` stays a
numpy string array.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import data
from ..core.base_components import DiagnosticComponent
from ..core.dataarray import as_tensor, to_numpy
from ..core.surface_fluxes import bulk_fluxes
from ..core.util import area_mask, resolve_device

_CODE_TO_NAME = {0: 'sea', 1: 'land', 2: 'land_ice'}

_MONTH_DAYS = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                       float)
_MID_DOY = np.cumsum(_MONTH_DAYS) - _MONTH_DAYS + _MONTH_DAYS / 2.0


def _load_nc(path_or_ds):
    """dict of variables from a netCDF path (``data.load_netcdf``), a
    mapping, or an xarray-like Dataset (:39)."""
    if isinstance(path_or_ds, dict):
        return path_or_ds
    if hasattr(path_or_ds, 'variables'):        # xarray-like Dataset
        return {k: np.asarray(path_or_ds[k].values)
                for k in path_or_ds.variables}
    return data.load_netcdf(path_or_ds)


def _grid_points(state):
    """Host float64 (lat, lon mod 360) of a state's columns, for the
    setup of a grid's interpolation, and the torch dtype of the state's
    latitude."""
    lat = to_numpy(state['latitude']).reshape(-1)
    lon = np.mod(to_numpy(state['longitude']).reshape(-1).astype(float),
                 360.0)
    return lat.astype(float), lon, torch.as_tensor(lat[:0]).dtype


def bilinear_corners(src_lat, src_lon, lat, lon):
    """(rows, cols, weights), each (4, npoints): bilinear interpolation of
    a (src_lat, src_lon) field at the points is
    sum(weights * field[rows, cols], 0), with linear extrapolation beyond
    the source grid (scipy's RegularGridInterpolator with
    fill_value=None).  A source axis may ascend or descend."""
    def axis(grid, x):
        """(lower node, upper node, weight of the upper node) along an
        axis, in ascending order of the coordinate."""
        n = grid.size
        descending = grid[0] > grid[-1]
        ascending = grid[::-1] if descending else grid
        i = np.clip(np.searchsorted(ascending, x, side='right') - 1, 0,
                    n - 2)
        t = (x - ascending[i]) / (ascending[i + 1] - ascending[i])
        if descending:
            return n - 1 - i, n - 2 - i, t
        return i, i + 1, t

    i0, i1, y0 = axis(src_lat, lat)
    j0, j1, y1 = axis(src_lon, lon)
    rows = np.stack([i0, i0, i1, i1])
    cols = np.stack([j0, j1, j0, j1])
    weights = np.stack([(1 - y0) * (1 - y1), (1 - y0) * y1,
                        y0 * (1 - y1), y0 * y1])
    return rows, cols, weights


class LandMask(DiagnosticComponent):
    """Set ``area_type`` (and optionally topographic forcing) from data
    (:68), on ``device`` (the CUDA card unless the caller asks for
    another).

    Nearest-neighbour maps a categorical land/sea/land-ice geography onto
    the model grid; with ``load_topography=True`` bilinear interpolation
    also maps orography and ice-sheet thickness, emitted as
    ``surface_geopotential`` and ``land_ice_thickness`` tensors, zero on
    sea cells.  ``sea_ice`` is dynamic and owned by SeaIce, never set
    here.  The grid is fixed at the first call, as in JAX.
    """

    input_properties = {
        'latitude': {'dims': ['*'], 'units': 'degrees_north'},
        'longitude': {'dims': ['*'], 'units': 'degrees_east'},
    }
    diagnostic_properties = {
        'area_type': {'dims': ['*'], 'units': 'dimensionless'},
    }

    def __init__(self, mask_dataset=None, include_land_ice=True,
                 topography_dataset=None, load_topography=True,
                 device='cuda', **kwargs):
        self.device = resolve_device(device)
        ds = _load_nc(mask_dataset if mask_dataset is not None
                      else data.LAND_MASK)
        self._src_lat = np.asarray(ds['lat'], float)
        self._src_lon = np.asarray(ds['lon'], float)
        self._src_code = np.asarray(ds['area_type_code'])
        self._include_land_ice = include_land_ice
        self._weights = None

        self.diagnostic_properties = {
            'area_type': {'dims': ['*'], 'units': 'dimensionless'},
        }
        self._load_topography = load_topography
        if load_topography:
            tds = _load_nc(topography_dataset if topography_dataset
                           is not None else data.TOPOGRAPHY)
            self._topo_lat = np.asarray(tds['lat'], float)
            self._topo_lon = np.asarray(tds['lon'], float)
            self._topo = np.stack([
                np.asarray(tds['surface_geopotential'], float),
                np.asarray(tds['land_ice_thickness'], float)])
            self.diagnostic_properties.update({
                'surface_geopotential': {
                    'dims': ['*'], 'units': 'm^2 s^-2'},
                'land_ice_thickness': {'dims': ['*'], 'units': 'm'},
            })
        super().__init__(**kwargs)

    def _setup(self, state):
        """The nearest-neighbour indices of the grid (:124), and its
        area_type and topography."""
        lat, lon, dtype = _grid_points(state)
        self._weights = (
            np.abs(self._src_lat[None, :] - lat[:, None]).argmin(axis=1),
            np.abs(self._src_lon[None, :] - lon[:, None]).argmin(axis=1))
        codes = self._src_code[self._weights]
        area = np.empty(codes.shape, dtype='U100')
        for c, name in _CODE_TO_NAME.items():
            if c == 2 and not self._include_land_ice:
                name = 'land'
            area[codes == c] = name
        self._fixed = {'area_type': area}
        if self._load_topography:
            rows, cols, weights = bilinear_corners(
                self._topo_lat, self._topo_lon, lat, lon)
            topo = torch.as_tensor(self._topo[:, rows, cols], dtype=dtype,
                                   device=self.device)
            w = torch.as_tensor(weights, dtype=dtype, device=self.device)
            sea = area_mask(area, ['sea'], self.device)
            for name, corners in zip(
                    ('surface_geopotential', 'land_ice_thickness'), topo):
                value = torch.clamp((corners * w).sum(0), min=0.0)
                self._fixed[name] = torch.where(sea, 0.0, value)

    def array_call(self, state):
        if self._weights is None:
            self._setup(state)
        elif state['latitude'].shape != self._weights[0].shape:
            raise ValueError('LandMask was set up for a grid of {} columns, '
                             'not {}'.format(self._weights[0].shape,
                                             state['latitude'].shape))
        return {name: value.copy() if name == 'area_type' else value.clone()
                for name, value in self._fixed.items()}


def mid_month_values(monthly_means):
    """Mid-month boundary values whose piecewise-linear reconstruction
    reproduces the given monthly means (Taylor, Williamson & Zwiers 2000):
    the cyclic tridiagonal relation mean_m = mm[m-1]/8 + 3 mm[m]/4 +
    mm[m+1]/8, solved directly on the host (:153)."""
    means = np.asarray(monthly_means, float)
    n = means.shape[0]
    A = np.zeros((n, n))
    for m in range(n):
        A[m, (m - 1) % n] += 0.125
        A[m, m] += 0.75
        A[m, (m + 1) % n] += 0.125
    x = np.linalg.solve(A, means.reshape(n, -1))
    return x.reshape(means.shape)


def month_weights(model_time):
    """(m0, m1, frac): a model time between the mid-points of months m0
    and m1 (cyclic 365-day year; true calendar day of year) (:169)."""
    doy = ((model_time - type(model_time)(model_time.year, 1, 1)).days
           + (model_time.hour * 3600 + model_time.minute * 60
              + model_time.second) / 86400.0)
    mids = _MID_DOY
    if doy <= mids[0] or doy >= mids[-1]:
        span = mids[0] + (365.0 - mids[11])
        if doy <= mids[0]:
            frac = (doy + (365.0 - mids[11])) / span
        else:
            frac = (doy - mids[11]) / span
        return 11, 0, frac
    m1 = int(np.searchsorted(mids, doy))
    m0 = m1 - 1
    return m0, m1, (doy - mids[m0]) / (mids[m1] - mids[m0])


def interp_time(mid_month, model_time):
    """Piecewise-linear evaluation of mid-month values (numpy or tensor,
    months first) at a model time (:169)."""
    m0, m1, frac = month_weights(model_time)
    return (1 - frac) * mid_month[m0] + frac * mid_month[m1]


class DataOcean(DiagnosticComponent):
    """Prescribe observed SSTs on ``area_type == 'sea'`` cells (:190), on
    ``device`` (the CUDA card unless the caller asks for another).

    Loads a (time, lat, lon) SST dataset, nearest-valid-fills masked
    source points, converts monthly means to mid-month values, and per
    call interpolates in time then space onto the model grid, whose
    bilinear corners are fixed at the first call.
    ``surface_temperature`` is overwritten only on sea cells.
    """

    input_properties = {
        'latitude': {'dims': ['*'], 'units': 'degrees_north'},
        'longitude': {'dims': ['*'], 'units': 'degrees_east'},
        'area_type': {'dims': ['*'], 'units': 'dimensionless'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
    }
    diagnostic_properties = {
        'sea_surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
    }

    def __init__(self, sst_dataset=None, sst_variable='tos',
                 time_interpolation='mid_month', relaxation_timescale=None,
                 compute_fluxes=False, device='cuda', **kwargs):
        self.device = resolve_device(device)
        self._compute_fluxes = compute_fluxes
        if compute_fluxes:
            self.input_properties = dict(self.input_properties)
            self.input_properties.update({
                'eastward_wind': {'dims': ['*'], 'units': 'm/s'},
                'northward_wind': {'dims': ['*'], 'units': 'm/s'},
                'air_temperature': {'dims': ['*'], 'units': 'degK'},
                'specific_humidity': {'dims': ['*'], 'units': 'kg/kg'},
                'surface_specific_humidity': {
                    'dims': ['*'], 'units': 'kg/kg'},
                'air_density': {'dims': ['*'], 'units': 'kg/m^3'},
            })
            self.diagnostic_properties = dict(self.diagnostic_properties)
            self.diagnostic_properties.update({
                'surface_upward_sensible_heat_flux': {
                    'dims': ['*'], 'units': 'W m^-2'},
                'surface_upward_latent_heat_flux': {
                    'dims': ['*'], 'units': 'W m^-2'},
            })
        ds = _load_nc(sst_dataset if sst_dataset is not None
                      else data.SST)
        raw = np.asarray(ds[sst_variable], float)
        units = ''
        if isinstance(ds, dict) and '__units__' in ds:
            units = ds['__units__'].get(sst_variable, '').strip().lower()
        if units in ('degc', 'c', 'celsius', 'degrees_c', 'degrees c',
                     'degrees celsius', 'deg_c'):
            raw = raw + 273.15
        self._src_lat = np.asarray(ds['lat'], float)
        self._src_lon = np.asarray(ds['lon'], float)
        self._filled = self._fill_source(raw)
        self._time_interp = time_interpolation
        self._mid = (mid_month_values(self._filled)
                     if time_interpolation == 'mid_month' else self._filled)
        # JAX asserts per call that the SST is finite on sea cells; a
        # bilinear blend of finite values is finite, so check them once
        assert np.all(np.isfinite(self._mid))
        self._relaxation_timescale = relaxation_timescale
        self._grid = None
        super().__init__(**kwargs)

    def _fill_source(self, raw):
        """Nearest-valid fill of the non-finite source points (:251)."""
        from scipy.spatial import cKDTree
        out = raw.copy()
        LON, LAT = np.meshgrid(self._src_lon, self._src_lat)
        for t in range(out.shape[0]):
            layer = out[t]
            mask = ~np.isfinite(layer)
            if not mask.any():
                continue
            good = ~mask
            tree = cKDTree(np.c_[LAT[good], LON[good]])
            _, idx = tree.query(np.c_[LAT[mask], LON[mask]])
            layer[mask] = layer[good][idx]
        return out

    def _setup(self, state, dtype):
        """The bilinear corners of every month of the source at the
        grid's columns, and their weights, on the device."""
        lat, lon, _ = _grid_points(state)
        rows, cols, weights = bilinear_corners(self._src_lat, self._src_lon,
                                               lat, lon)
        return (lat.shape,
                torch.as_tensor(self._mid[:, rows, cols], dtype=dtype,
                                device=self.device),
                torch.as_tensor(weights, dtype=dtype, device=self.device))

    def array_call(self, state):
        def a(name):
            return as_tensor(state[name], self.device)

        surf = a('surface_temperature')
        if self._grid is None or self._grid[0] != state['latitude'].shape:
            self._grid = self._setup(state, surf.dtype)
        _, corners, weights = self._grid
        t = state['time']
        if self._time_interp == 'mid_month':
            field = interp_time(corners, t)
        else:
            field = corners[t.month - 1]
        sst = (field * weights).sum(0)
        sea = area_mask(state['area_type'], ['sea'], self.device)
        surf = torch.where(sea, sst, surf)
        diagnostics = {
            'sea_surface_temperature': sst,
            'surface_temperature': surf,
        }
        if self._compute_fluxes:
            fluxes = bulk_fluxes(
                wind_speed=torch.sqrt(a('eastward_wind') ** 2
                                      + a('northward_wind') ** 2),
                surface_temperature=surf,
                air_temperature=a('air_temperature'),
                surface_specific_humidity=a('surface_specific_humidity'),
                air_specific_humidity=a('specific_humidity'),
                air_density=a('air_density'))
            diagnostics['surface_upward_sensible_heat_flux'] = \
                fluxes['sensible_heat_flux']
            diagnostics['surface_upward_latent_heat_flux'] = \
                fluxes['latent_heat_flux']
        return diagnostics
