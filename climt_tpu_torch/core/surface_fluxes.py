"""Shared bulk aerodynamic surface-flux formulae
(climt_tpu/core/surface_fluxes.py).

One bulk coefficient times wind speed, with the air-density factors that
make the fluxes dimensionally correct.  Pure elementwise arithmetic: it
takes tensors or numpy arrays, as the JAX one takes jax or numpy arrays.
"""

from __future__ import annotations


def bulk_fluxes(wind_speed, surface_temperature, air_temperature,
                surface_specific_humidity, air_specific_humidity,
                air_density, bulk_coefficient=0.0011, latent_heat=2.5e6,
                beta=1.0, heat_capacity=1004.0):
    """E = beta * C_D * U * (q_s - q_a); latent = L * rho * E;
    sensible = rho * c_p * C_D * U * (T_s - T_a) (:16)."""
    U = wind_speed
    rho = air_density
    potential_evap = bulk_coefficient * U * (
        surface_specific_humidity - air_specific_humidity)
    evaporation_rate = beta * potential_evap
    latent = latent_heat * rho * evaporation_rate
    sensible = (rho * bulk_coefficient * U
                * (surface_temperature - air_temperature) * heat_capacity)
    return {
        'sensible_heat_flux': sensible,
        'latent_heat_flux': latent,
        'evaporation_rate': evaporation_rate,
    }
