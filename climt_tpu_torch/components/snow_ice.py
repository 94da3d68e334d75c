"""SeaIce and LandIce, 1-D thermodynamic snow/ice columns, and the
deprecated IceSheet shim over both (climt_tpu/components/snow_ice.py).

Every column is stepped at once: one batched Crank-Nicolson tridiagonal
solve (ops/tridiagonal.py), and a second one selected per column where a
melting surface conducts more than its forcing (the cool-and-resolve
pass).  State fields are read as tensors on ``device``; ``area_type``
stays a numpy string array and becomes masks on the host.  Two values
come back to the host per call, as in JAX: whether a column is taller
than the maximum height (which raises) and the count of columns whose
negative melt energy was clamped (a debug log message).
"""

from __future__ import annotations

import logging
import warnings

import torch

from ..core.base_components import Stepper, timestep_seconds
from ..core.constants import get_constant
from ..core.dataarray import as_tensor
from ..core.util import area_mask, resolve_device
from ..ops.tridiagonal import tridiagonal_solve

logger = logging.getLogger(__name__)

_EPSILON = 1e-5


def _round6(x):
    """round(x, 6) on the growth/melt energies (:38); torch.round rounds
    half to even, as jnp.round does."""
    return torch.round(x * 1e6) / 1e6


def _solve_columns(rho, cp, kappa, temp, dt, dz,
                   top_dirichlet, top_val, bot_dirichlet, bot_val):
    """Batched Crank-Nicolson column solve (:43).

    Arrays are (n_layers, ncol); index 0 is the column BOTTOM.  rho, cp
    and kappa live on the n_layers-1 material layers between nodes.
    top_dirichlet is a per-column bool tensor, bot_dirichlet one bool for
    every column: True applies a Dirichlet value, False a downward flux
    (Neumann) condition."""
    heat_capacity = rho * cp
    hc_int = 0.5 * (heat_capacity[:-1] + heat_capacity[1:])
    k_int = 0.5 * (kappa[:-1] + kappa[1:])
    mu_inv = dt / (hc_int * 2.0 * dz * dz)

    r = torch.zeros_like(temp)
    r[1:-1] = k_int * mu_inv
    dp = 1.0 + 2.0 * r
    dm = 1.0 - 2.0 * r
    a_sub = torch.zeros_like(temp)
    a_sub[1:-1] = -mu_inv * kappa[:-1]
    a_sup = torch.zeros_like(temp)
    a_sup[1:-1] = -mu_inv * kappa[1:]

    rhs = dm * temp
    rhs[1:-1] += (mu_inv * kappa[:-1] * temp[:-2]
                  + mu_inv * kappa[1:] * temp[2:])

    # top boundary (node n-1)
    one = torch.ones_like(top_val)
    a_sub[-1] = torch.where(top_dirichlet, 0.0, one)
    dp[-1] = torch.where(top_dirichlet, one, -1.0)
    a_sup[-1] = 0.0
    rhs[-1] = torch.where(top_dirichlet, top_val,
                          -top_val * dz / kappa[-1])

    # bottom boundary (node 0)
    a_sup[0] = 0.0 if bot_dirichlet else 1.0
    dp[0] = 1.0 if bot_dirichlet else -1.0
    a_sub[0] = 0.0
    rhs[0] = bot_val if bot_dirichlet else -bot_val * dz / kappa[0]

    return tridiagonal_solve(a_sub, dp, a_sup, rhs)


def _snow_ice_step(active, temp_in, ice_in, snow_in, net_flux,
                   bot_dirichlet, bot_val, dt,
                   rho_ice, rho_snow, c_ice, c_snow, k_ice, k_snow,
                   lf, t_melt, albedo_snow, albedo_ice, albedo_melt,
                   clamp_to_flux):
    """Shared sea-ice / land-ice column step over all columns at once
    (:86).

    bot_dirichlet/bot_val: the basal boundary (LandIce: Dirichlet soil
    temperature; SeaIce: flux -q_ocean).  clamp_to_flux (SeaIce) grows or
    melts ice at the base and routes the energy of a clamped thickness
    into the returned basal flux; LandIce clamps both thicknesses plainly.

    Returns (temp, ice, snow, surface_T, heights, basal_flux,
    surface_flux, ground_flux, albedo, neg_energy).
    """
    def full(value):
        return torch.full_like(ice_in, value)

    n_layers = temp_in.shape[0]
    n_mat = n_layers - 1

    total_in = ice_in + snow_in
    safe_height = torch.where(active, total_in, 1.0)
    dz = safe_height / n_layers
    snow_fraction = snow_in / safe_height
    level_idx = torch.arange(n_mat, device=temp_in.device)[:, None]
    snow_level = ((1.0 - snow_fraction) * n_layers).to(torch.int32) - 1
    is_snow = level_idx > snow_level[None, :]

    rho = torch.where(is_snow, rho_snow, full(rho_ice))
    cp = torch.where(is_snow, c_snow, full(c_ice))
    kappa = torch.where(is_snow, k_snow, full(k_ice))

    surf0 = temp_in[-1]
    check_melting = surf0 >= t_melt - _EPSILON

    # first solve: melting surface -> Dirichlet T_melt, else flux
    new_temp = _solve_columns(
        rho, cp, kappa, temp_in, dt, dz,
        check_melting, torch.where(check_melting, t_melt, net_flux),
        bot_dirichlet, bot_val)

    flux_through = ((new_temp[-1] - new_temp[-2])
                    * (kappa[-1] + kappa[-2]) * 0.5 / dz)
    # cool-and-resolve: melting surface but conduction exceeds forcing
    need_resolve = (surf0 > t_melt - _EPSILON) & (flux_through > net_flux)
    cooled = temp_in.clone()
    cooled[-1] += torch.where(need_resolve, -10.0 * _EPSILON, full(0.0))
    resolved = _solve_columns(
        rho, cp, kappa, cooled, dt, dz,
        torch.zeros_like(check_melting), net_flux,      # flux top everywhere
        bot_dirichlet, bot_val)
    new_temp = torch.where(need_resolve[None, :], resolved, new_temp)
    check_melting = check_melting & ~need_resolve

    # basal fluxes
    basal_grad_flux = _round6((new_temp[1] - new_temp[0])
                              * (kappa[0] + kappa[1]) * 0.5 / dz)
    ground_flux = (new_temp[0] - new_temp[1]) * kappa[0] / dz

    # SeaIce: basal growth/melt from the conducted flux at the base
    growth = -(basal_grad_flux * dt / (rho[0] * lf))
    ice = ice_in + growth if clamp_to_flux else ice_in
    basal_flux_out = basal_grad_flux

    # surface conducted flux after the final solve
    flux_through = ((new_temp[-1] - new_temp[-2])
                    * (kappa[-1] + kappa[-2]) * 0.5 / dz)

    # surface melt
    energy_to_melt = _round6((net_flux - flux_through) * dt)
    neg_energy = check_melting & (energy_to_melt < 0.0)
    energy_to_melt = torch.clamp(energy_to_melt, min=0.0)
    melt_height = torch.where(check_melting,
                              energy_to_melt / (rho[-1] * lf), 0.0)
    snow_melted_out = melt_height > snow_in
    snow = torch.where(check_melting,
                       torch.where(snow_melted_out, 0.0,
                                   snow_in - melt_height),
                       snow_in)
    ice = torch.where(check_melting & snow_melted_out,
                      ice - (melt_height - snow_in), ice)

    # thickness clamping
    pre_clip = ice
    ice = torch.clamp(ice, min=0.0)
    if clamp_to_flux:
        leftover = torch.where(pre_clip < 0.0,
                               -pre_clip * rho[-1] * lf / dt, 0.0)
        basal_flux_out = basal_flux_out + leftover
    snow = torch.clamp(snow, min=0.0)

    total_out = ice + snow
    iface = torch.arange(n_layers, device=temp_in.device)[:, None]
    heights = total_out[None, :] * iface / (n_layers - 1)

    albedo = torch.where(snow > 0.0, albedo_snow, full(albedo_ice))
    albedo = torch.where(melt_height > 0.0, albedo_melt, albedo)

    return (new_temp, ice, snow, new_temp[-1], heights, basal_flux_out,
            flux_through, ground_flux, albedo, neg_energy)


_FLUX_PROPS_2D = {
    'downwelling_longwave_flux_in_air': {
        'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
    'downwelling_shortwave_flux_in_air': {
        'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
    'upwelling_longwave_flux_in_air': {
        'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
    'upwelling_shortwave_flux_in_air': {
        'dims': ['*', 'interface_levels'], 'units': 'W m^-2'},
}


class _SnowIceBase(Stepper):
    def __init__(self, maximum_snow_ice_height=10, albedo_snow=0.8,
                 albedo_ice=0.5, albedo_melt=0.2, device='cuda', **kwargs):
        """maximum_snow_ice_height caps the combined snow+ice column (m);
        the three albedos (snow / bare ice / melting surface) are
        configurable."""
        self.device = resolve_device(device)
        self._max_height = maximum_snow_ice_height
        self._albedo_snow = albedo_snow
        self._albedo_ice = albedo_ice
        self._albedo_melt = albedo_melt
        super().__init__(**kwargs)

    def _constants(self):
        return dict(
            k_ice=get_constant(
                'thermal_conductivity_of_solid_phase_as_ice', 'W/m/degK'),
            k_snow=get_constant(
                'thermal_conductivity_of_solid_phase_as_snow', 'W/m/degK'),
            rho_ice=get_constant('density_of_solid_phase_as_ice', 'kg/m^3'),
            c_ice=get_constant(
                'heat_capacity_of_solid_phase_as_ice', 'J/kg/degK'),
            rho_snow=get_constant(
                'density_of_solid_phase_as_snow', 'kg/m^3'),
            c_snow=get_constant(
                'heat_capacity_of_solid_phase_as_snow', 'J/kg/degK'),
            lf=get_constant('latent_heat_of_fusion', 'J/kg'),
            t_melt=get_constant(
                'freezing_temperature_of_liquid_phase', 'degK'),
        )

    def _tensor(self, raw_state, name):
        return as_tensor(raw_state[name], self.device)

    def _net_flux(self, raw_state):
        """Net downward surface flux (:227)."""
        def a(name):
            return self._tensor(raw_state, name)

        return (a('downwelling_shortwave_flux_in_air')[:, 0]
                + a('downwelling_longwave_flux_in_air')[:, 0]
                - a('upwelling_shortwave_flux_in_air')[:, 0]
                - a('upwelling_longwave_flux_in_air')[:, 0]
                - a('surface_upward_sensible_heat_flux')
                - a('surface_upward_latent_heat_flux'))

    def _step(self, raw_state, timestep, active, temp, thickness, snow,
              bot_dirichlet, bot_val, clamp_to_flux):
        c = self._constants()
        return _snow_ice_step(
            active, temp, thickness, snow, self._net_flux(raw_state),
            bot_dirichlet, bot_val, timestep_seconds(timestep),
            c['rho_ice'], c['rho_snow'], c['c_ice'], c['c_snow'],
            c['k_ice'], c['k_snow'], c['lf'], c['t_melt'],
            self._albedo_snow, self._albedo_ice, self._albedo_melt,
            clamp_to_flux)

    def _check_height(self, too_tall):
        if bool(torch.any(too_tall)):
            raise ValueError(
                'Total height exceeds maximum value of {} m.'.format(
                    self._max_height))

    def _outputs(self, raw_state, act, thickness_name, thickness, snow,
                 temp, stepped, kind):
        """The outputs of both components, and a debug message counting
        the columns whose negative melt energy was clamped."""
        new_temp, ice, snow_out, surf_t, heights = stepped[:5]
        albedo, neg_energy = stepped[8:]
        n_neg = int(torch.sum(neg_energy & act))
        if n_neg:
            logger.debug('Negative melt energy clamped to 0 on %d '
                         '%s columns.', n_neg, kind)
        on_act = torch.where(act, albedo, 0.0)
        return {
            thickness_name: torch.where(act, ice, thickness),
            'surface_snow_thickness': torch.where(act, snow_out, snow),
            'snow_and_ice_temperature': torch.where(act[None, :], new_temp,
                                                    temp),
            'surface_temperature': torch.where(act, surf_t, temp[-1]),
            'height_on_ice_interface_levels': torch.where(
                act[None, :], heights,
                self._tensor(raw_state, 'height_on_ice_interface_levels')),
        }, {
            'surface_albedo_for_direct_shortwave': on_act,
            'surface_albedo_for_diffuse_shortwave': on_act,
        }


class SeaIce(_SnowIceBase):
    """1-D thermodynamic sea-ice columns over ``area_type == 'sea_ice'``
    (:239), on ``device`` (the CUDA card unless the caller asks for
    another).

    Basal boundary: prescribed ocean heat flux
    (heat_flux_into_sea_water_due_to_sea_ice), so ice can grow or melt at
    the base; thickness is clamped non-negative with the excess energy
    routed back into the ocean heat flux.
    """

    input_properties = dict(_FLUX_PROPS_2D, **{
        'surface_upward_latent_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_upward_sensible_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'sea_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
        'area_type': {'dims': ['*'], 'units': 'dimensionless'},
        'snow_and_ice_temperature': {
            'dims': ['ice_interface_levels', '*'], 'units': 'degK'},
        'sea_surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'heat_flux_into_sea_water_due_to_sea_ice': {
            'dims': ['*'], 'units': 'W m^-2'},
        'height_on_ice_interface_levels': {
            'dims': ['ice_interface_levels', '*'], 'units': 'm'},
    })

    output_properties = {
        'sea_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'snow_and_ice_temperature': {
            'dims': ['ice_interface_levels', '*'], 'units': 'degK'},
        'height_on_ice_interface_levels': {
            'dims': ['ice_interface_levels', '*'], 'units': 'm'},
    }

    diagnostic_properties = {
        'heat_flux_into_sea_water_due_to_sea_ice': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_downward_heat_flux_in_sea_ice': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_albedo_for_direct_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
        'surface_albedo_for_diffuse_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
    }

    def array_call(self, raw_state, timestep):
        def a(name):
            return self._tensor(raw_state, name)

        thickness = a('sea_ice_thickness')
        snow = a('surface_snow_thickness')
        temp = a('snow_and_ice_temperature')
        q_ocean = a('heat_flux_into_sea_water_due_to_sea_ice')
        total_in = thickness + snow
        owned = area_mask(raw_state['area_type'], ['sea_ice'], self.device)
        has_ice = owned & (thickness > 0.0)
        self._check_height(has_ice & (total_in > self._max_height))
        act = has_ice & (total_in >= _EPSILON)

        stepped = self._step(raw_state, timestep, act, temp, thickness,
                             snow, False, -q_ocean, True)
        outputs, diagnostics = self._outputs(
            raw_state, act, 'sea_ice_thickness', thickness, snow, temp,
            stepped, 'sea-ice')
        diagnostics.update({
            'heat_flux_into_sea_water_due_to_sea_ice': torch.where(
                act, stepped[5], q_ocean),
            'surface_downward_heat_flux_in_sea_ice': torch.where(
                act, stepped[6], 0.0),
        })
        return diagnostics, outputs


class LandIce(_SnowIceBase):
    """1-D snow/ice columns over ``area_type in ('land', 'land_ice')``
    (:344), on ``device`` (the CUDA card unless the caller asks for
    another).

    Basal boundary: Dirichlet soil surface temperature; the conducted
    basal exchange is reported as
    ``upward_heat_flux_at_ground_level_in_soil``.
    """

    def __init__(self, maximum_snow_ice_height=10, albedo_snow=0.8,
                 albedo_ice=0.6, albedo_melt=0.2, device='cuda', **kwargs):
        """Bare-ice default albedo is 0.6 over land ice (SeaIce's is
        0.5)."""
        super().__init__(maximum_snow_ice_height=maximum_snow_ice_height,
                         albedo_snow=albedo_snow, albedo_ice=albedo_ice,
                         albedo_melt=albedo_melt, device=device, **kwargs)

    input_properties = dict(_FLUX_PROPS_2D, **{
        'surface_upward_latent_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_upward_sensible_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'land_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
        'area_type': {'dims': ['*'], 'units': 'dimensionless'},
        'snow_and_ice_temperature': {
            'dims': ['ice_interface_levels', '*'], 'units': 'degK'},
        'soil_surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'height_on_ice_interface_levels': {
            'dims': ['ice_interface_levels', '*'], 'units': 'm'},
    })

    output_properties = {
        'land_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'snow_and_ice_temperature': {
            'dims': ['ice_interface_levels', '*'], 'units': 'degK'},
        'height_on_ice_interface_levels': {
            'dims': ['ice_interface_levels', '*'], 'units': 'm'},
    }

    diagnostic_properties = {
        'upward_heat_flux_at_ground_level_in_soil': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_albedo_for_direct_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
        'surface_albedo_for_diffuse_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
    }

    def array_call(self, raw_state, timestep):
        def a(name):
            return self._tensor(raw_state, name)

        thickness = a('land_ice_thickness')
        snow = a('surface_snow_thickness')
        temp = a('snow_and_ice_temperature')
        total_in = thickness + snow
        is_land = area_mask(raw_state['area_type'], ['land', 'land_ice'],
                            self.device)
        self._check_height(is_land & (total_in > self._max_height))
        act = is_land & (total_in >= _EPSILON)

        stepped = self._step(raw_state, timestep, act, temp, thickness,
                             snow, True, a('soil_surface_temperature'),
                             False)
        outputs, diagnostics = self._outputs(
            raw_state, act, 'land_ice_thickness', thickness, snow, temp,
            stepped, 'land-ice')
        diagnostics['upward_heat_flux_at_ground_level_in_soil'] = \
            torch.where(act, stepped[7], 0.0)
        return diagnostics, outputs


class IceSheet(Stepper):
    """Deprecated monolith: a shim over SeaIce + LandIce (:448), on
    ``device`` (the CUDA card unless the caller asks for another).

    Runs both on the full state and merges per column; plain 'sea' columns
    (owned by neither) pass ``surface_temperature`` straight through.
    Emits a DeprecationWarning on construction.
    """

    input_properties = dict(_FLUX_PROPS_2D, **{
        'surface_upward_latent_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_upward_sensible_heat_flux': {
            'dims': ['*'], 'units': 'W m^-2'},
        'land_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'sea_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
        'area_type': {'dims': ['*'], 'units': 'dimensionless'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'snow_and_ice_temperature': {
            'dims': ['ice_interface_levels', '*'], 'units': 'degK'},
        'sea_surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'soil_surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'height_on_ice_interface_levels': {
            'dims': ['ice_interface_levels', '*'], 'units': 'm'},
        'heat_flux_into_sea_water_due_to_sea_ice': {
            'dims': ['*'], 'units': 'W m^-2'},
    })

    output_properties = {
        'land_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'sea_ice_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_snow_thickness': {'dims': ['*'], 'units': 'm'},
        'surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'snow_and_ice_temperature': {
            'dims': ['ice_interface_levels', '*'], 'units': 'degK'},
        'sea_surface_temperature': {'dims': ['*'], 'units': 'degK'},
        'height_on_ice_interface_levels': {
            'dims': ['ice_interface_levels', '*'], 'units': 'm'},
    }

    diagnostic_properties = {
        'heat_flux_into_sea_water_due_to_sea_ice': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_downward_heat_flux_in_sea_ice': {
            'dims': ['*'], 'units': 'W m^-2'},
        'upward_heat_flux_at_ground_level_in_soil': {
            'dims': ['*'], 'units': 'W m^-2'},
        'surface_albedo_for_direct_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
        'surface_albedo_for_diffuse_shortwave': {
            'dims': ['*'], 'units': 'dimensionless'},
    }

    def __init__(self, maximum_snow_ice_height=10, device='cuda', **kwargs):
        warnings.warn(
            'IceSheet is deprecated; use SeaIce and LandIce directly.',
            DeprecationWarning, stacklevel=2)
        self.device = resolve_device(device)
        self._sea = SeaIce(maximum_snow_ice_height=maximum_snow_ice_height,
                           device=device)
        self._land = LandIce(
            maximum_snow_ice_height=maximum_snow_ice_height, device=device)
        super().__init__(**kwargs)

    def array_call(self, raw_state, timestep):
        sea_diag, sea_out = self._sea.array_call(raw_state, timestep)
        land_diag, land_out = self._land.array_call(raw_state, timestep)

        area_type = raw_state['area_type']
        sea_mask = area_mask(area_type, ['sea_ice'], self.device)
        land_mask = area_mask(area_type, ['land', 'land_ice'], self.device)

        def merged(key, sea, land):
            return torch.where(sea_mask, sea[key], land[key])

        # three-way surface_temperature merge: un-owned 'sea' cells keep
        # the input rather than either component's derived proxy
        surf = as_tensor(raw_state['surface_temperature'], self.device)
        surf = torch.where(land_mask, land_out['surface_temperature'], surf)
        surf = torch.where(sea_mask, sea_out['surface_temperature'], surf)
        outputs = {
            'surface_snow_thickness': merged('surface_snow_thickness',
                                             sea_out, land_out),
            'surface_temperature': surf,
            'sea_ice_thickness': sea_out['sea_ice_thickness'],
            'land_ice_thickness': land_out['land_ice_thickness'],
            'sea_surface_temperature': as_tensor(
                raw_state['sea_surface_temperature'], self.device),
        }
        for key in ('snow_and_ice_temperature',
                    'height_on_ice_interface_levels'):
            outputs[key] = torch.where(sea_mask[None, :], sea_out[key],
                                       land_out[key])
        diagnostics = {
            'heat_flux_into_sea_water_due_to_sea_ice':
                sea_diag['heat_flux_into_sea_water_due_to_sea_ice'],
            'surface_downward_heat_flux_in_sea_ice':
                sea_diag['surface_downward_heat_flux_in_sea_ice'],
            'upward_heat_flux_at_ground_level_in_soil':
                land_diag['upward_heat_flux_at_ground_level_in_soil'],
        }
        for key in ('surface_albedo_for_direct_shortwave',
                    'surface_albedo_for_diffuse_shortwave'):
            diagnostics[key] = merged(key, sea_diag, land_diag)
        return diagnostics, outputs
