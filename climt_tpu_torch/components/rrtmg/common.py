"""Shared option maps and validation for the RRTMG radiation components
(climt_tpu/components/rrtmg/common.py, copied: it imports no JAX).

The string -> integer flag dictionaries of climt's rrtmg_common.py and the
option-consistency messages its components log at construction.
"""

from __future__ import annotations

import logging

rrtmg_cloud_overlap_method_dict = {
    'clear_only': 0,
    'random': 1,
    'maximum_random': 2,
    'maximum': 3,
}

rrtmg_cloud_props_dict = {
    'direct_input': 0,
    'single_cloud_type': 1,
    'liquid_and_ice_clouds': 2,
}

rrtmg_cloud_ice_props_dict = {
    'ebert_curry_one': 0,
    'ebert_curry_two': 1,
    'key_streamer_manual': 2,
    'fu': 3,
}

rrtmg_cloud_liquid_props_dict = {
    'radius_independent_absorption': 0,
    'radius_dependent_absorption': 1,
}

rrtmg_aerosol_input_dict = {
    'no_aerosol': 0,
    'ecmwf': 6,
    'all_aerosol_properties': 10,
}

rrtmg_random_number_dict = {
    'kissvec': 0,
    'mersenne_twister': 1,
}


def validate_mcica_options(mcica, cloud_overlap_method,
                           cloud_optical_properties,
                           cloud_ice_properties=None,
                           cloud_liquid_water_properties=None,
                           shortwave=False):
    """Log the same configuration advisories the reference emits."""
    if not mcica:
        return
    if cloud_overlap_method == 'clear_only':
        logging.info(
            "cloud_overlap_method == 'clear_only', meaning no clouds; "
            "McICA will have no effect.")
    if cloud_optical_properties == 'single_cloud_type':
        logging.info(
            "cloud_optical_properties must be 'direct_input' or "
            "'liquid_and_ice_clouds' when using McICA.")
    if shortwave and cloud_optical_properties == 'liquid_and_ice_clouds':
        if cloud_ice_properties == 'ebert_curry_one':
            logging.info(
                "cloud_ice_properties should not be set to "
                "'ebert_curry_one' when using McICA.")
        if cloud_liquid_water_properties == \
                'radius_independent_absorption':
            logging.info(
                "cloud_liquid_water_properties must be set to "
                "'radius_dependent_absorption' when using McICA.")
