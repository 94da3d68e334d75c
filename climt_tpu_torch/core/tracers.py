"""Tracer packing registry (climt_tpu/core/tracers.py).

Behavioral parity with the sympl tracer system the reference exercises
(CliMT's tests/test_components.py:23,87-89 — ``reset_tracers`` /
``reset_packers``; usage contract described in SURVEY.md §2.1): arbitrary
named quantities can be registered as tracers, and a TracerPacker packs
them into a single (tracer, ...) array for components (dynamical cores)
that advect tracers generically, then unpacks outputs back to named
quantities.
"""

from __future__ import annotations

import numpy as np
import torch

from .dataarray import common_backend
from .properties import extract_arrays, restore_arrays

_tracer_names = []
_tracer_units = {}
_packers = set()


def register_tracer(name, units):
    """Register a quantity name as a tracer to be packed for dycores."""
    if name in _tracer_names:
        if _tracer_units[name] != units:
            raise ValueError(
                'Tracer {} already registered with units {}'.format(
                    name, _tracer_units[name]))
        return
    _tracer_names.append(name)
    _tracer_units[name] = units
    for packer in _packers:
        packer._on_registry_change()


def get_tracer_names():
    return tuple(_tracer_names)


def get_tracer_unit_dict():
    return dict(_tracer_units)


def reset_tracers():
    """Clear the tracer registry (test isolation)."""
    del _tracer_names[:]
    _tracer_units.clear()


def reset_packers():
    """Forget all live packers (test isolation)."""
    _packers.clear()


class TracerPacker:
    """Packs registered tracers into one array for a wrapped component.

    Args:
        component: the component whose ``input_properties`` the packed
            tracers supplement (its dims template is used).
        dims: dims of each tracer in the packed array (e.g.
            ['tracer', 'mid_levels', '*']); the leading entry must be
            'tracer'.
    """

    def __init__(self, component, dims):
        if len(dims) == 0 or dims[0] != 'tracer':
            raise ValueError("dims must begin with 'tracer'")
        self._dims = list(dims)
        self._component = component
        _packers.add(self)
        self._on_registry_change()

    def _on_registry_change(self):
        self.tracer_names = tuple(_tracer_names)

    @property
    def tracer_dims(self):
        return tuple(self._dims)

    def pack(self, state):
        """State dict -> packed (n_tracers, ...) raw array."""
        properties = {
            name: {'dims': self._dims[1:], 'units': _tracer_units[name]}
            for name in self.tracer_names}
        raw, wildcard = extract_arrays(state, properties)
        self._wildcard = wildcard
        if not self.tracer_names:
            return np.zeros((0,))
        arrays = common_backend(*(raw[name] for name in self.tracer_names))
        if isinstance(arrays[0], torch.Tensor):
            return torch.stack(arrays)
        return np.stack(arrays)

    def unpack(self, packed, input_state):
        """Packed array -> dict of labeled DataArrays."""
        out = {}
        properties = {
            name: {'dims': self._dims[1:], 'units': _tracer_units[name]}
            for name in self.tracer_names}
        raw = {name: packed[i] for i, name in enumerate(self.tracer_names)}
        return restore_arrays(raw, properties, self._wildcard)
