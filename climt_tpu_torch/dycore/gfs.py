"""GFSDynamicalCore: the climt Stepper that wraps the spectral
primitive-equation solver together with physics components
(climt_tpu/dycore/gfs.py).

``GFSDynamicalCore([physics...], number_of_damped_levels=N)`` contains the
physics and steps them with the dynamics; ``diagnostics, new_state =
dycore(state, timestep)``.  Stepper-type physics must be wrapped in
``TimeDifferencingWrapper`` first.  Each call marshals the state on the
host, calls the wrapped components, and takes one step of the
``SpectralDycore`` (float64, on ``device``), which it builds at the first
call from the state's grid.  Moisture moves in spectral space, or in grid
space with ``moisture_advection='fv'``/``'sl'``; registered tracers
(``core/tracers.py``) always move in grid space by the flux-form
``FVAdvection``.
"""

from __future__ import annotations

import torch

from ..core.base_components import (
    ImplicitTendencyComponent, Stepper, TendencyComponent, timestep_seconds)
from ..core.constants import get_constant
from ..core.dataarray import as_tensor, to_numpy
from ..core.properties import extract_arrays
from ..core.tracers import TracerPacker
from ..core.util import resolve_device
from ..ops.fv_advection import FVAdvection
from .spectral_dynamics import SpectralDycore


class GFSDynamicalCore(Stepper):
    """Spectral dynamical core containing a list of physics components."""

    _base_input_properties = {
        'eastward_wind': {'dims': ['mid_levels', 'lat', 'lon'],
                          'units': 'm s^-1'},
        'northward_wind': {'dims': ['mid_levels', 'lat', 'lon'],
                           'units': 'm s^-1'},
        'air_temperature': {'dims': ['mid_levels', 'lat', 'lon'],
                            'units': 'degK'},
        'specific_humidity': {'dims': ['mid_levels', 'lat', 'lon'],
                              'units': 'kg/kg'},
        'surface_air_pressure': {'dims': ['lat', 'lon'], 'units': 'Pa'},
        'surface_geopotential': {'dims': ['lat', 'lon'],
                                 'units': 'm^2 s^-2'},
        'atmosphere_hybrid_sigma_pressure_a_coordinate_on_interface_levels': {
            'dims': ['interface_levels'], 'units': 'dimensionless',
            'alias': 'ak'},
        'atmosphere_hybrid_sigma_pressure_b_coordinate_on_interface_levels': {
            'dims': ['interface_levels'], 'units': 'dimensionless',
            'alias': 'bk'},
    }

    output_properties = {
        'eastward_wind': {'dims': ['mid_levels', 'lat', 'lon'],
                          'units': 'm s^-1'},
        'northward_wind': {'dims': ['mid_levels', 'lat', 'lon'],
                           'units': 'm s^-1'},
        'air_temperature': {'dims': ['mid_levels', 'lat', 'lon'],
                            'units': 'degK'},
        'specific_humidity': {'dims': ['mid_levels', 'lat', 'lon'],
                              'units': 'kg/kg'},
        'surface_air_pressure': {'dims': ['lat', 'lon'], 'units': 'Pa'},
        'air_pressure': {'dims': ['mid_levels', 'lat', 'lon'],
                         'units': 'Pa'},
        'air_pressure_on_interface_levels': {
            'dims': ['interface_levels', 'lat', 'lon'], 'units': 'Pa'},
        'divergence_of_wind': {'dims': ['mid_levels', 'lat', 'lon'],
                               'units': 's^-1'},
        'atmosphere_relative_vorticity': {
            'dims': ['mid_levels', 'lat', 'lon'], 'units': 's^-1'},
    }

    @property
    def diagnostic_properties(self):
        """Wrapped components' diagnostics pass through the dycore call
        (gfs.py:77); the dycore itself computes none, so the restore path
        sees {}."""
        if getattr(self, '_restoring', False):
            return {}
        combined = {}
        for comp in getattr(self, '_components', ()):
            combined.update(getattr(comp, 'diagnostic_properties', {}))
        return combined

    def __init__(self, tendency_component_list=None,
                 number_of_damped_levels=0,
                 damping_timescale=2.0 * 86400.0,
                 truncation=None,
                 asselin_strength=0.05,
                 moist=True, moisture_advection='spectral', device='cuda',
                 **kwargs):
        """``device``: where the dynamics runs (the CUDA card unless the
        caller asks for another; without a card the default raises here,
        although the ``SpectralDycore`` is built at the first call).
        ``moisture_advection``: 'spectral', 'fv' or 'sl' (see
        ``SpectralDycore``).  Registered tracers are always transported
        by ``FVAdvection`` on the dycore's diagnosed mass fluxes
        (gfs.py:100-106)."""
        self._device = resolve_device(device)
        self._moisture_advection = moisture_advection
        self._tracer_packer = TracerPacker(
            self, ['tracer', 'mid_levels', 'lat', 'lon'])
        self._fv = None
        self._pending_tracers = None
        self._advected_tracers = None
        self._components = list(tendency_component_list or [])
        for comp in self._components:
            if not isinstance(comp, (TendencyComponent,
                                     ImplicitTendencyComponent)) and \
                    not hasattr(comp, 'tendency_properties'):
                raise TypeError(
                    'GFSDynamicalCore wraps TendencyComponents; wrap '
                    'Steppers in TimeDifferencingWrapper first '
                    '(got {})'.format(type(comp)))
        self._n_damped = number_of_damped_levels
        self._damping_timescale = damping_timescale
        self._truncation = truncation
        self._asselin = asselin_strength
        self._moist = moist
        self._dycore = None
        self._prev = None
        super().__init__(**kwargs)

    @property
    def input_properties(self):
        """Union of dycore + wrapped-component inputs (used by
        get_default_state); extraction uses only the dycore's own fields —
        each wrapped component marshals its own inputs at call time."""
        combined = dict(self._base_input_properties)
        for comp in self._components:
            for name, spec in comp.input_properties.items():
                combined.setdefault(name, spec)
        return combined

    @property
    def restoration_properties(self):
        """Output restoration must not see wrapped components' aliases."""
        return self._base_input_properties

    def _extract(self, state):
        return extract_arrays(state, self._base_input_properties)

    def _ensure_dycore(self, nlon, nlat, nz, ak, bk, dt):
        if self._dycore is not None and self._dycore.dt == dt:
            return
        # default truncation follows the reference dycore's nlon//3 - 2
        # (gfs.py:156)
        truncation = self._truncation
        if truncation is None:
            truncation = max(nlon // 3 - 2, 1)
        self._dycore = SpectralDycore(
            nlon, nlat, nz, ak, bk,
            truncation=truncation,
            timestep=dt,
            number_of_damped_levels=self._n_damped,
            damping_timescale=self._damping_timescale,
            asselin_strength=self._asselin,
            moisture_advection=self._moisture_advection,
            rd=get_constant('gas_constant_of_dry_air', 'J/kg/degK'),
            cpd=get_constant(
                'heat_capacity_of_dry_air_at_constant_pressure',
                'J/kg/degK'),
            g=get_constant('gravitational_acceleration', 'm/s^2'),
            radius=get_constant('planetary_radius', 'm'),
            omega=get_constant('planetary_rotation_rate', 's^-1'),
            dtype=torch.float64, device=self._device)
        self._prev = None

    def _grid(self, x):
        """A raw field as a float64 tensor on the dycore's device."""
        return as_tensor(x, self._device, torch.float64)

    def _physics_tendencies(self, state, timestep, shape3d):
        """Run wrapped components and sum their tendencies as top-down
        (nz, nlat, nlon) grids (gfs.py:180)."""
        if not self._components:
            return None
        zeros = torch.zeros(shape3d, dtype=torch.float64,
                            device=self._device)
        phys = {'du': zeros, 'dv': zeros, 'dT': zeros, 'dq': zeros}
        targets = {'eastward_wind': ('du', 'm s^-2'),
                   'northward_wind': ('dv', 'm s^-2'),
                   'air_temperature': ('dT', 'degK s^-1'),
                   'specific_humidity': ('dq', 's^-1')}

        def to_topdown(value, target_units):
            arr = value.to_units(target_units)
            if set(arr.dims) == {'mid_levels', 'lat', 'lon'}:
                arr = arr.transpose('mid_levels', 'lat', 'lon')
            return torch.flip(self._grid(arr.values), [0])

        for comp in self._components:
            if isinstance(comp, ImplicitTendencyComponent) or (
                    not isinstance(comp, TendencyComponent)
                    and hasattr(comp, 'tendency_properties')):
                try:
                    tendencies, diags = comp(state, timestep)
                except TypeError:
                    tendencies, diags = comp(state)
            else:
                tendencies, diags = comp(state)
            self._collected_diagnostics.update(diags)
            for name, value in tendencies.items():
                if name in targets:
                    key, units = targets[name]
                    phys[key] = phys[key] + to_topdown(value, units)
        return phys

    def array_call(self, raw_state, timestep):
        dt = timestep_seconds(timestep)
        nz, nlat, nlon = raw_state['eastward_wind'].shape
        self._ensure_dycore(nlon, nlat, nz, to_numpy(raw_state['ak']),
                            to_numpy(raw_state['bk']), dt)
        dyc = self._dycore

        # bottom-up state -> top-down internal grids
        def td(name):
            return torch.flip(self._grid(raw_state[name]), [0])

        ps = self._grid(raw_state['surface_air_pressure'])
        dyc.set_surface_geopotential(
            self._grid(raw_state['surface_geopotential']))
        spec_in = dyc.spectral_state_from_grid(
            td('eastward_wind'), td('northward_wind'),
            td('air_temperature'), td('specific_humidity'), torch.log(ps))

        if self._prev is None:
            # leapfrog start: forward half/full step from the initial state
            _, new = dyc.initial_step(spec_in)
            self._prev = spec_in
        else:
            # continue the leapfrog: the centre state is the externally
            # (physics-)updated grid state, the previous one the filtered
            # memory
            filtered, new, _ = dyc.step(self._prev, spec_in)
            self._prev = filtered

        g = dyc.grid_state_from_spectral(new)
        ps_new = torch.exp(g['lnps'])
        p_half = dyc.A[:, None, None] + dyc.B[:, None, None] * ps_new[None]
        rk = dyc.kappa
        dp = p_half[1:] - p_half[:-1]
        p_full = ((p_half[1:] ** (rk + 1) - p_half[:-1] ** (rk + 1))
                  / ((rk + 1) * dp)) ** (1.0 / rk)
        vort_g = dyc.sht.synthesize(new['vort'])
        div_g = dyc.sht.synthesize(new['div'])

        def bu(x):
            return torch.flip(x, [0])

        # physics applied as a split (forward-Euler) update on the new
        # state, injected through the truncated spectral round trip: the
        # reference dycore's behaviour, which its cached
        # TestGFSDycoreWithHeldSuarez state encodes (gfs.py:267-291)
        u_out, v_out, T_out, q_out = g['u'], g['v'], g['T'], g['q']
        phys = self._phys_for_state
        if phys is not None:
            sht = dyc.sht
            cosl = dyc.coslat[:, None]
            dvort, ddiv = sht.vort_div_analysis(phys['du'] * cosl,
                                                phys['dv'] * cosl)
            du_t, dv_t = sht.uv_from_vort_div(dvort, ddiv)
            u_out = u_out + dt * du_t
            v_out = v_out + dt * dv_t
            T_out = T_out + dt * sht.synthesize(sht.analyze(phys['dT']))
            if dyc.fv is not None:
                q_out = q_out + dt * phys['dq']   # grid-space moisture
            else:
                q_out = q_out + dt * sht.synthesize(
                    sht.analyze(phys['dq']))

        # registered tracers: conservative grid-space transport on the
        # input state's diagnosed mass fluxes over dt, all tracers in one
        # batch (gfs.py:293-302)
        if self._pending_tracers is not None:
            u_c, v_c, dp_c, mdot_c = dyc.diagnose_mass_fluxes(spec_in)
            packed_td = torch.flip(self._grid(self._pending_tracers), [1])
            adv = self._ensure_fv(dt).advect(packed_td, dp_c, u_c, v_c,
                                             mdot_c, dt)
            self._advected_tracers = torch.flip(adv, [1])

        q_new = torch.clamp(q_out, min=0.0) if self._moist else q_out
        outputs = {
            'eastward_wind': bu(u_out),
            'northward_wind': bu(v_out),
            'air_temperature': bu(T_out),
            'specific_humidity': bu(q_new),
            'surface_air_pressure': ps_new,
            'air_pressure': bu(p_full),
            'air_pressure_on_interface_levels': bu(p_half),
            'divergence_of_wind': bu(div_g),
            'atmosphere_relative_vorticity': bu(vort_g),
        }
        return {}, outputs

    def _ensure_fv(self, dt):
        """The tracers' FV operator, built at the first tracer call for
        that call's dt (gfs.py:318)."""
        if self._fv is None:
            dyc = self._dycore
            self._fv = FVAdvection(
                dyc.sht.mu, dyc.sht.weights, dyc.nlon, dyc.radius,
                dt_max=2.0 * dt, dtype=dyc.dtype, device=self._device)
        return self._fv

    def __call__(self, state, timestep):
        self._phys_for_state = None
        self._collected_diagnostics = {}
        if self._components:
            shape = state['eastward_wind'].transpose(
                'mid_levels', 'lat', 'lon').shape
            self._phys_for_state = self._physics_tendencies(
                state, timestep, shape)
        # pack registered tracers (climt's tracer contract)
        self._pending_tracers = None
        self._advected_tracers = None
        packer = self._tracer_packer
        if packer.tracer_names:
            self._pending_tracers = packer.pack(state)
        self._restoring = True
        try:
            diagnostics, new_state = super().__call__(state, timestep)
        finally:
            self._restoring = False
        if self._advected_tracers is not None:
            tracers = packer.unpack(self._advected_tracers, state)
            # the dycore's own prognostics keep the dycore's update
            for name in list(tracers):
                if name in new_state:
                    tracers.pop(name)
            new_state.update(tracers)
        # wrapped components' diagnostics pass through (gfs.py:357)
        merged = dict(self._collected_diagnostics)
        merged.update(diagnostics)
        return merged, new_state
