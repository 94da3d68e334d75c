"""CorkLongwaveRadiation: CORK correlated-k / picket-fence LW radiation
(climt_tpu/components/cork/lw.py).

Two optics modes: 'correlated_k' (table-driven, per-band g-point
quadrature, optional H2O/CO2 runtime axes and decoupled H2O continuum) and
'parmentier' (two-band picket-fence with Freedman Rosseland means).  The
transport is the two-stream diffusivity approximation trans = exp(-D tau)
with a configurable D (``diffusivity_factor``; Elsasser 1.66 default).

The JAX module's two ``lax.scan``s over levels are Python loops over
levels here, each level one update of the whole (nband, ngpt, ncol) block
in JAX's operation order and one weighted g-sum per band; the per-g-point
profiles are kept only for ``diagnostics_level`` 1.  Everything runs on
the component's ``device`` at the state's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.base_components import TendencyComponent
from ...core.constants import get_constant
from ...core.dataarray import as_tensor
from ...core.initialization import set_num_longwave_bands
from ...core.util import resolve_device
from .ck_tables import (compute_ck_optical_depth, load_k_table,
                        overlap_method, table_tensors)
from .common import (MOLAR_MASS, MOLAR_MASS_DRY_AIR, bracket,
                     compute_column_amount, compute_heating_rate)
from .parmentier import (compute_rosseland_mean_opacity,
                         compute_thermal_opacities,
                         load_freedman2014_coefficients,
                         load_parmentier_coefficients,
                         lookup_ratio_coefficients)

DIFFUSIVITY_FACTOR = 1.66


def planck_sources(planck_frac, T_grid, T, T_surf, sigma, nband, ngpt,
                   is_esft):
    """Planck layer and surface sources per (band, g-point).

    planck_frac: (nband_orig, ngpt_orig, nT) tensor; T (nlev, ncol);
    T_surf (ncol,).  Returns planck_src (nband, ngpt, nlev, ncol),
    surf_src (nband, ngpt, ncol): the fraction, linear in T with the
    ``bracket`` clamps, times sigma T^4, with ESFT-expanded g-points
    mapped back to the table's (lw.py:35)."""
    nband_orig, ngpt_orig, _ = planck_frac.shape
    ib = np.minimum(np.arange(nband), nband_orig - 1)
    ig = (np.arange(ngpt) % ngpt_orig) if is_esft else np.arange(ngpt)
    dev = planck_frac.device
    pf = planck_frac[torch.as_tensor(ib, device=dev)][
        :, torch.as_tensor(ig, device=dev)]          # (nband, ngpt, nT)

    def interp(temps):
        flat = temps.reshape(-1)
        iT, fT = bracket(T_grid, flat)
        frac = pf[:, :, iT].mul_(1.0 - fT)
        frac.addcmul_(pf[:, :, iT + 1], fT)
        return frac.mul_(sigma * flat ** 4).reshape(
            (nband, ngpt) + temps.shape)

    return interp(T), interp(T_surf)


def lw_transport(tau, planck_src, surf_src, emissivity, weights,
                 diffusivity_factor, want_diag=False):
    """Two-stream diffusivity LW transport over all (band, g, column).

    tau/planck_src (nband, ngpt, nlev, ncol); surf_src (nband, ngpt,
    ncol); emissivity (nband, ncol); weights (nband, ngpt).  Returns
    (up_band, down_band, up_broad, down_broad, diag): per-band interface
    fluxes (nband, nlev+1, ncol), their band sums, and with ``want_diag``
    {'transmittance' (nband, ngpt, nlev, ncol), 'up_per_gpoint' and
    'down_per_gpoint' (nband, ngpt, nlev+1, ncol), weighted}, else None
    (lw.py:58)."""
    nband, ngpt, nlev, ncol = tau.shape
    w = weights[:, :, None]
    trans = torch.mul(tau, -diffusivity_factor).exp_()
    # src (1 - trans) of every level, the recurrences' second term
    emitted = torch.rsub(trans, 1.0).mul_(planck_src)
    if want_diag:
        up_g = tau.new_empty((nband, ngpt, nlev + 1, ncol))
        dn_g = tau.new_zeros((nband, ngpt, nlev + 1, ncol))

    up = emissivity[:, None, :] * surf_src
    up_sums = [(w * up).sum(1)]
    if want_diag:
        up_g[:, :, 0] = up
    for k in range(nlev):
        up = torch.addcmul(emitted[:, :, k], up, trans[:, :, k])
        up_sums.append((w * up).sum(1))
        if want_diag:
            up_g[:, :, k + 1] = up
    up_band = torch.stack(up_sums, dim=1)

    dn = torch.zeros_like(up)
    dn_sums = [torch.zeros_like(up_sums[0])]
    for k in range(nlev - 1, -1, -1):
        dn = torch.addcmul(emitted[:, :, k], dn, trans[:, :, k])
        dn_sums.append((w * dn).sum(1))
        if want_diag:
            dn_g[:, :, k] = dn
    down_band = torch.stack(dn_sums[::-1], dim=1)
    del emitted

    up_broad = up_band.sum(0)
    down_broad = down_band.sum(0)
    if not want_diag:
        return up_band, down_band, up_broad, down_broad, None
    w4 = weights[:, :, None, None]
    diag = {'transmittance': trans, 'up_per_gpoint': up_g.mul_(w4),
            'down_per_gpoint': dn_g.mul_(w4)}
    return up_band, down_band, up_broad, down_broad, diag


def _band_last(x):
    """(nband, ..., ncol) -> (..., ncol, nband)."""
    return torch.movedim(x, 0, -1)


class CorkLongwaveRadiation(TendencyComponent):
    """CORK longwave radiation with per-band diagnostics."""

    def __init__(self, optics='correlated_k', table=None,
                 coefficients='solar_composition',
                 rosseland_mean_fit='freedman2014',
                 diffusivity_factor=DIFFUSIVITY_FACTOR, diagnostics_level=0,
                 device='cuda', **kwargs):
        """optics='correlated_k' runs a shipped or user k-table (see
        ck_tables.load_k_table); optics='parmentier' runs the two-band
        picket-fence scheme with the Rosseland means of Freedman et al.
        2014, the one fit shipped, whatever ``rosseland_mean_fit`` names
        (JAX accepts the argument and ignores it, cork/lw.py:122).
        diffusivity_factor sets D in trans = exp(-D tau);
        diagnostics_level 1 adds the g-point-averaged transmittance and
        per-g-point fluxes.  Declares the band count
        (``set_num_longwave_bands``) for the default state."""
        self.device = resolve_device(device)
        self._diffusivity_factor = diffusivity_factor
        self._optics_mode = optics
        self._has_co2_axis = False
        self._tensors = {}
        if optics == 'parmentier':
            self._coefficients = load_parmentier_coefficients(coefficients)
            self._freedman_coeffs = load_freedman2014_coefficients()
            self._num_bands = 2
        elif optics == 'correlated_k':
            self._table = load_k_table(table)
            self._num_bands = self._table['k_coefficients'].shape[1]
            self._num_gpts = self._table['k_coefficients'].shape[2]
            self._gas_names = [str(g) for g in
                               np.atleast_1d(self._table['gas_names'])]
            has_h2o_axis = 'h2o_vmr_grid' in self._table
            self._has_co2_axis = 'co2_vmr_grid' in self._table
            self._fully_premixed = (self._gas_names == ['effective']
                                    and not has_h2o_axis)
            self._premixed_bg = (
                (self._gas_names == ['effective'] and has_h2o_axis)
                or str(self._table.get('background_is_premixed',
                                       np.array(''))).lower() == 'true')
        else:
            raise ValueError('Unknown optics mode: {}'.format(optics))
        self._diagnostics_level = diagnostics_level
        set_num_longwave_bands(self._num_bands)
        super().__init__(**kwargs)

    @property
    def input_properties(self):
        props = {
            'air_temperature': {'dims': ['mid_levels', '*'],
                                'units': 'degK', 'alias': 'T'},
            'air_pressure': {'dims': ['mid_levels', '*'], 'units': 'Pa',
                             'alias': 'p'},
            'air_pressure_on_interface_levels': {
                'dims': ['interface_levels', '*'], 'units': 'Pa',
                'alias': 'p_int'},
            'surface_temperature': {'dims': ['*'], 'units': 'degK',
                                    'alias': 'T_surf'},
            'surface_longwave_emissivity': {
                'dims': ['num_longwave_bands', '*'],
                'units': 'dimensionless', 'alias': 'emissivity'},
        }
        if self._optics_mode == 'parmentier':
            props['irradiation_temperature'] = {
                'dims': ['*'], 'units': 'degK', 'alias': 'T_irr'}
            props['internal_temperature'] = {
                'dims': ['*'], 'units': 'degK', 'alias': 'T_int'}
        elif self._premixed_bg:
            props['specific_humidity'] = {
                'dims': ['mid_levels', '*'], 'units': 'kg/kg',
                'alias': 'h2o'}
            if self._has_co2_axis:
                props['mole_fraction_of_carbon_dioxide_in_air'] = {
                    'dims': ['mid_levels', '*'], 'units': 'mole/mole',
                    'alias': 'co2'}
        elif not self._fully_premixed:
            gas_cf = {'h2o': 'specific_humidity',
                      'co2': 'mole_fraction_of_carbon_dioxide_in_air'}
            gas_units = {'h2o': 'kg/kg'}
            for gas in self._gas_names:
                cf = gas_cf.get(gas, 'mole_fraction_of_{}_in_air'.format(gas))
                props[cf] = {'dims': ['mid_levels', '*'],
                             'units': gas_units.get(gas, 'mole/mole'),
                             'alias': gas}
        props['longwave_optical_thickness_due_to_cloud'] = {
            'dims': ['mid_levels', '*', 'num_longwave_bands'],
            'units': 'dimensionless', 'alias': 'tau_cloud_lw'}
        return props

    @property
    def tendency_properties(self):
        return {'air_temperature': {'units': 'degK s^-1'}}

    @property
    def diagnostic_properties(self):
        flux = {'dims': ['interface_levels', '*'], 'units': 'W m^-2'}
        band_flux = {'dims': ['interface_levels', '*', 'num_longwave_bands'],
                     'units': 'W m^-2'}

        def band_mid(units):
            return {'dims': ['mid_levels', '*', 'num_longwave_bands'],
                    'units': units}

        props = {
            'upwelling_longwave_flux_in_air': dict(flux),
            'downwelling_longwave_flux_in_air': dict(flux),
            'upwelling_longwave_flux_in_air_per_band': dict(band_flux),
            'downwelling_longwave_flux_in_air_per_band': dict(band_flux),
            'air_temperature_tendency_from_longwave': {
                'dims': ['mid_levels', '*'], 'units': 'degK day^-1'},
            'longwave_optical_depth_per_band': band_mid('dimensionless'),
            'longwave_transmittance_per_band': band_mid('dimensionless'),
            'air_temperature_tendency_from_longwave_per_band':
                band_mid('degK day^-1'),
        }
        if self._diagnostics_level >= 1:
            props['lw_layer_transmittance'] = band_mid('dimensionless')
            props['lw_up_per_gpoint'] = dict(band_flux)
            props['lw_down_per_gpoint'] = dict(band_flux)
        return props

    @property
    def num_longwave_bands(self):
        return self._num_bands

    def _tables(self, dtype):
        """The table's tensors of ``dtype`` on the device, made at the
        first call in that dtype: ``table_tensors`` and the Planck
        fractions and g-point weights, or the Parmentier coefficients."""
        if dtype not in self._tensors:
            if self._optics_mode == 'parmentier':
                # the per-region tables; the boundaries and the gamma_P
                # polynomial stay host scalars
                self._tensors[dtype] = {
                    k: (torch.as_tensor(v, dtype=dtype, device=self.device)
                        if k.endswith('_ab') else v)
                    for k, v in self._coefficients.items()}
            else:
                tt = table_tensors(self._table, dtype, self.device)
                for name in ('planck_fraction', 'gpoint_weights'):
                    tt[name] = torch.as_tensor(
                        np.asarray(self._table[name], float), dtype=dtype,
                        device=self.device)
                self._tensors[dtype] = tt
        return self._tensors[dtype]

    def array_call(self, state):
        def tensor(name):
            return as_tensor(state[name], self.device)

        T, p, p_int, T_surf = (tensor(n) for n in ('T', 'p', 'p_int',
                                                   'T_surf'))
        sigma = get_constant('stefan_boltzmann_constant', 'W/m^2/K^4')
        g = get_constant('gravitational_acceleration', 'm/s^2')
        cpd = get_constant(
            'heat_capacity_of_dry_air_at_constant_pressure', 'J/kg/K')

        if self._optics_mode == 'parmentier':
            tau, planck_src, surf_src = self._parmentier_optics(
                T, p, p_int, T_surf, tensor('T_irr'), tensor('T_int'),
                sigma, g)
            weights = torch.ones(tau.shape[:2], dtype=T.dtype,
                                 device=self.device)
        else:
            tau, planck_src, surf_src, weights = self._ck_optics(
                tensor, T, p, p_int, T_surf, sigma, g)

        # + the cloud (nlev, ncol, nband), in place on the fresh tau
        tau.add_(torch.movedim(tensor('tau_cloud_lw'), -1, 0)[:, None])

        want_diag = self._diagnostics_level > 0
        up_band, down_band, up_broad, down_broad, kdiag = lw_transport(
            tau, planck_src, surf_src, tensor('emissivity'), weights,
            self._diffusivity_factor, want_diag=want_diag)
        del planck_src, surf_src

        heating = compute_heating_rate(up_broad - down_broad, p_int, g, cpd)

        D = self._diffusivity_factor
        tau_band = torch.einsum('bglc,bg->blc', tau, weights)
        del tau
        # compute_heating_rate per band
        net = up_band - down_band
        hr_band = (g / cpd * (net[:, 1:] - net[:, :-1])
                   / (p_int[1:] - p_int[:-1])[None]) * 86400.0

        diagnostics = {
            'upwelling_longwave_flux_in_air': up_broad,
            'downwelling_longwave_flux_in_air': down_broad,
            'upwelling_longwave_flux_in_air_per_band': _band_last(up_band),
            'downwelling_longwave_flux_in_air_per_band':
                _band_last(down_band),
            'air_temperature_tendency_from_longwave': heating * 86400.0,
            'longwave_optical_depth_per_band': _band_last(tau_band),
            'longwave_transmittance_per_band': _band_last(
                torch.exp(-D * tau_band)),
            'air_temperature_tendency_from_longwave_per_band':
                _band_last(hr_band),
        }
        if want_diag:
            w_sum = weights.sum(dim=1)

            def avg(x):                          # (nband, ngpt, ..., ncol)
                return _band_last(
                    torch.einsum('bg...,bg->b...', x, weights)
                    / w_sum[(slice(None),) + (None,) * (x.dim() - 2)])

            diagnostics['lw_layer_transmittance'] = avg(
                kdiag['transmittance'])
            diagnostics['lw_up_per_gpoint'] = avg(kdiag['up_per_gpoint'])
            diagnostics['lw_down_per_gpoint'] = avg(
                kdiag['down_per_gpoint'])
        return ({'T': heating}, diagnostics)

    def _ck_optics(self, tensor, T, p, p_int, T_surf, sigma, g):
        tt = self._tables(T.dtype)
        h2o_vmr = co2_vmr = None
        if self._fully_premixed:
            gas_amounts = compute_column_amount(
                torch.ones_like(T), p_int, g)[None]
        elif self._premixed_bg:
            q = tensor('h2o')
            gas_amounts = compute_column_amount(
                torch.ones_like(q), p_int, g)[None]
            m_ratio = MOLAR_MASS['h2o'] / MOLAR_MASS_DRY_AIR
            h2o_vmr = q / torch.clamp(q + (1.0 - q) * m_ratio, min=1e-30)
            if self._has_co2_axis:
                co2_vmr = tensor('co2')
        else:
            amounts = []
            for gas in self._gas_names:
                q = tensor(gas)
                if gas != 'h2o':
                    q = q * (MOLAR_MASS.get(gas, MOLAR_MASS_DRY_AIR)
                             / MOLAR_MASS_DRY_AIR)
                amounts.append(compute_column_amount(q, p_int, g))
            gas_amounts = torch.stack(amounts)

        result = compute_ck_optical_depth(
            self._table, T, p, gas_amounts, h2o_vmr=h2o_vmr,
            co2_vmr=co2_vmr, tensors=tt)
        if isinstance(result, tuple):
            tau, weights = result
            weights = torch.as_tensor(weights, dtype=T.dtype,
                                      device=self.device)
        else:
            tau, weights = result, tt['gpoint_weights']
        nband, ngpt = tau.shape[:2]
        is_esft = (overlap_method(self._table) == 'esft'
                   and len(self._gas_names) > 1)
        planck_src, surf_src = planck_sources(
            tt['planck_fraction'], tt['T_grid'], T, T_surf, sigma, nband,
            ngpt, is_esft)
        return tau, planck_src, surf_src, weights

    def _parmentier_optics(self, T, p, p_int, T_surf, T_irr, T_int, sigma,
                           g):
        # T_eff per column (Lee et al. 2021 Eq. 20; A_B=0, mu*=1/4)
        T_eff = torch.clamp((T_int ** 4 + 0.25 * T_irr ** 4) ** 0.25,
                            min=100.0)
        _, _, _, beta, gamma_P, R = lookup_ratio_coefficients(
            self._tables(T.dtype), T_eff)
        kappa_R = compute_rosseland_mean_opacity(T, p, self._freedman_coeffs)
        kappa_1, kappa_2 = compute_thermal_opacities(
            kappa_R, gamma_P[None, :], beta[None, :], R[None, :])
        mass = torch.abs(p_int[1:] - p_int[:-1]) / g
        tau = torch.stack([kappa_1 * mass, kappa_2 * mass])[:, None]
        planck = sigma * T ** 4
        planck_src = torch.stack(
            [beta[None, :] * planck, (1.0 - beta)[None, :] * planck])[:, None]
        surf_planck = sigma * T_surf ** 4
        surf_src = torch.stack(
            [beta * surf_planck, (1.0 - beta) * surf_planck])[:, None]
        return tau, planck_src, surf_src
