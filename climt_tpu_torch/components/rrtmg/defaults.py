"""Default optical-property initializers for the RRTMG radiation schemes
(climt_tpu/components/rrtmg/defaults.py, numpy only).

Behavioral parity with CliMT's climt/_core/initialization.py:90-192:
clear-sky defaults (zero cloud/aerosol optics, unit surface emissivity,
standard asymmetry/single-scattering values) broadcast over the grid.
"""

from __future__ import annotations

import numpy as np

from ...core.base_components import DiagnosticComponent

NUM_LONGWAVE_BANDS = 16
NUM_SHORTWAVE_BANDS = 14
NUM_ECMWF_AEROSOLS = 6


class RRTMGLongwaveDefaultValues(DiagnosticComponent):

    input_properties = {
        'air_pressure': {
            'dims': ['*', 'mid_levels'],
            'units': 'Pa',
        },
    }

    diagnostic_properties = {
        'surface_longwave_emissivity': {
            'dims': ['num_longwave_bands', '*'],
            'units': 'dimensionless',
        },
        'longwave_optical_thickness_due_to_cloud': {
            'dims': ['mid_levels', '*', 'num_longwave_bands'],
            'units': 'dimensionless',
        },
        'longwave_optical_thickness_due_to_aerosol': {
            'dims': ['num_longwave_bands', 'mid_levels', '*'],
            'units': 'dimensionless',
        },
    }

    def array_call(self, state):
        from ...core.initialization import get_num_longwave_bands
        nb = get_num_longwave_bands()
        ncol, nz = state['air_pressure'].shape
        return {
            'surface_longwave_emissivity': np.ones([nb, ncol]),
            'longwave_optical_thickness_due_to_cloud': np.zeros(
                [nz, ncol, nb]),
            'longwave_optical_thickness_due_to_aerosol': np.zeros(
                [nb, nz, ncol]),
        }


class RRTMGShortwaveDefaultValues(DiagnosticComponent):

    input_properties = {
        'air_pressure': {
            'dims': ['mid_levels', '*'],
            'units': 'Pa',
        },
    }

    diagnostic_properties = {
        'shortwave_optical_thickness_due_to_cloud': {
            'dims': ['mid_levels', '*', 'num_shortwave_bands'],
            'units': 'dimensionless',
        },
        'cloud_asymmetry_parameter': {
            'dims': ['mid_levels', '*', 'num_shortwave_bands'],
            'units': 'dimensionless',
        },
        'cloud_forward_scattering_fraction': {
            'dims': ['mid_levels', '*', 'num_shortwave_bands'],
            'units': 'dimensionless',
        },
        'single_scattering_albedo_due_to_cloud': {
            'dims': ['mid_levels', '*', 'num_shortwave_bands'],
            'units': 'dimensionless',
        },
        'shortwave_optical_thickness_due_to_aerosol': {
            'dims': ['num_shortwave_bands', 'mid_levels', '*'],
            'units': 'dimensionless',
        },
        'aerosol_asymmetry_parameter': {
            'dims': ['num_shortwave_bands', 'mid_levels', '*'],
            'units': 'dimensionless',
        },
        'single_scattering_albedo_due_to_aerosol': {
            'dims': ['num_shortwave_bands', 'mid_levels', '*'],
            'units': 'dimensionless',
        },
        'aerosol_optical_depth_at_55_micron': {
            'dims': ['num_ecmwf_aerosols', 'mid_levels', '*'],
            'units': 'dimensionless',
        },
    }

    def array_call(self, state):
        nz, ncol = state['air_pressure'].shape
        nb = NUM_SHORTWAVE_BANDS
        return {
            'shortwave_optical_thickness_due_to_cloud':
                np.zeros([nz, ncol, nb]),
            'cloud_asymmetry_parameter':
                0.85 * np.ones([nz, ncol, nb]),
            'cloud_forward_scattering_fraction':
                0.8 * np.ones([nz, ncol, nb]),
            'single_scattering_albedo_due_to_cloud':
                0.9 * np.ones([nz, ncol, nb]),
            'shortwave_optical_thickness_due_to_aerosol':
                np.zeros([nb, nz, ncol]),
            'aerosol_asymmetry_parameter':
                np.zeros([nb, nz, ncol]),
            'single_scattering_albedo_due_to_aerosol':
                0.5 * np.ones([nb, nz, ncol]),
            'aerosol_optical_depth_at_55_micron':
                np.zeros([NUM_ECMWF_AEROSOLS, nz, ncol]),
        }
