"""Component base classes: the four component kinds of the framework
(climt_tpu/core/base_components.py).

The reference delegates these to sympl (pinned in
CliMT's setup.py:43; contracts documented in
CliMT's docs/component_types.rst:4-21):

- ``TendencyComponent``:        ``__call__(state) -> (tendencies, diagnostics)``
- ``DiagnosticComponent``:      ``__call__(state) -> diagnostics``
- ``Stepper``:                  ``__call__(state, timestep) -> (diagnostics, new_state)``
- ``ImplicitTendencyComponent``: tendencies but requires the timestep.

Subclasses declare ``input_properties`` / ``tendency_properties`` /
``diagnostic_properties`` / ``output_properties`` dicts and implement
``array_call(raw_state[, timestep])`` over raw arrays (shape convention:
vertical dim first, flattened '*' column axis last).  ``array_call`` bodies in
this package compute on torch tensors on the component's device; this
host-side layer only does metadata marshalling.
"""

from __future__ import annotations

import abc
from datetime import timedelta

from .properties import (
    compute_wildcard_info, extract_arrays, restore_arrays)


def timestep_seconds(timestep):
    if isinstance(timestep, timedelta):
        return timestep.total_seconds()
    return float(timestep)


class ComponentBase(abc.ABC):
    input_properties = {}
    name = None

    def __init__(self, name=None, **kwargs):
        if name is not None:
            self.name = name
        elif self.name is None:
            self.name = self.__class__.__name__.lower()
        # accepted for API parity; diagnostics of tendencies handled below
        self._tendencies_in_diagnostics = kwargs.pop(
            'tendencies_in_diagnostics', False)
        if kwargs:
            raise TypeError(
                'Unexpected keyword arguments {}'.format(tuple(kwargs)))

    def _extract(self, state):
        return extract_arrays(state, self.input_properties)

    def __repr__(self):
        return '{}(name={!r})'.format(self.__class__.__name__, self.name)


class DiagnosticComponent(ComponentBase):
    """Computes diagnostics from the state without modifying it."""

    diagnostic_properties = {}

    def __call__(self, state):
        raw_state, wildcard = self._extract(state)
        raw_diagnostics = self.array_call(raw_state)
        return restore_arrays(
            raw_diagnostics, self.diagnostic_properties, wildcard,
            self.input_properties)

    @abc.abstractmethod
    def array_call(self, state):
        ...


class TendencyComponent(ComponentBase):
    """Computes time tendencies of prognostic quantities."""

    tendency_properties = {}
    diagnostic_properties = {}

    def __call__(self, state):
        raw_state, wildcard = self._extract(state)
        raw_tendencies, raw_diagnostics = self.array_call(raw_state)
        tendencies = restore_arrays(
            raw_tendencies, self.tendency_properties, wildcard,
            self.input_properties)
        diagnostics = restore_arrays(
            raw_diagnostics, self.diagnostic_properties, wildcard,
            self.input_properties)
        if self._tendencies_in_diagnostics:
            for name, value in tendencies.items():
                diagnostics[
                    '{}_tendency_from_{}'.format(name, self.name)] = value
        return tendencies, diagnostics

    @abc.abstractmethod
    def array_call(self, state):
        ...


class ImplicitTendencyComponent(ComponentBase):
    """Computes tendencies but needs the model timestep (e.g. vertical CFL
    limits, as in the reference's Emanuel scheme,
    CliMT's climt/_components/emanuel/component.py:17,244)."""

    tendency_properties = {}
    diagnostic_properties = {}

    def __call__(self, state, timestep):
        raw_state, wildcard = self._extract(state)
        raw_tendencies, raw_diagnostics = self.array_call(
            raw_state, timestep)
        tendencies = restore_arrays(
            raw_tendencies, self.tendency_properties, wildcard,
            self.input_properties)
        diagnostics = restore_arrays(
            raw_diagnostics, self.diagnostic_properties, wildcard,
            self.input_properties)
        if self._tendencies_in_diagnostics:
            for name, value in tendencies.items():
                diagnostics[
                    '{}_tendency_from_{}'.format(name, self.name)] = value
        return tendencies, diagnostics

    @abc.abstractmethod
    def array_call(self, state, timestep):
        ...


class Stepper(ComponentBase):
    """Steps the state forward in time internally (implicit schemes)."""

    diagnostic_properties = {}
    output_properties = {}

    def __call__(self, state, timestep):
        raw_state, wildcard = self._extract(state)
        raw_diagnostics, raw_new_state = self.array_call(raw_state, timestep)
        # components that merge other components' input properties (the
        # GFS dycore) expose ``restoration_properties`` so foreign aliases
        # don't leak into output restoration
        props = getattr(self, 'restoration_properties',
                        self.input_properties)
        diagnostics = restore_arrays(
            raw_diagnostics, self.diagnostic_properties, wildcard, props)
        new_state = restore_arrays(
            raw_new_state, self.output_properties, wildcard, props)
        return diagnostics, new_state

    @abc.abstractmethod
    def array_call(self, state, timestep):
        ...


class ConstantTendencyComponent(TendencyComponent):
    """Returns constant prescribed tendencies (testing/forcing utility)."""

    def __init__(self, tendencies, diagnostics=None, **kwargs):
        self.__tendencies = dict(tendencies)
        self.__diagnostics = dict(diagnostics or {})
        self.input_properties = {}
        self.tendency_properties = {
            name: {'dims': list(v.dims), 'units': v.units}
            for name, v in self.__tendencies.items()}
        self.diagnostic_properties = {
            name: {'dims': list(v.dims), 'units': v.units}
            for name, v in self.__diagnostics.items()}
        super().__init__(**kwargs)

    def __call__(self, state):
        return dict(self.__tendencies), dict(self.__diagnostics)

    def array_call(self, state):
        raise NotImplementedError


class ConstantDiagnosticComponent(DiagnosticComponent):
    """Returns constant prescribed diagnostics (testing utility)."""

    def __init__(self, diagnostics, **kwargs):
        self.__diagnostics = dict(diagnostics)
        self.input_properties = {}
        self.diagnostic_properties = {
            name: {'dims': list(v.dims), 'units': v.units}
            for name, v in self.__diagnostics.items()}
        super().__init__(**kwargs)

    def __call__(self, state):
        return dict(self.__diagnostics)

    def array_call(self, state):
        raise NotImplementedError
