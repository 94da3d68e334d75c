"""Behavioral component wrappers (climt_tpu/core/wrappers.py).

Mirror the contract of the reference's sympl wrappers
(CliMT's docs/configuration.rst:60-92 and usage at
CliMT's examples/gmd_aquaplanet.py:55-63):

- ``UpdateFrequencyWrapper``: cache a component's output and recompute only
  after a given interval of *model* time has passed (caching semantics tested
  at CliMT's tests/test_components.py:520-541).
- ``TimeDifferencingWrapper``: turn a Stepper into an implicit
  TendencyComponent via (x_out - x_in) / dt, required before inserting
  Steppers into the spectral dynamical core.
- ``ScalingWrapper``: scale inputs/outputs of any component
  (mechanism-denial experiments).
"""

from __future__ import annotations

from .base_components import (
    DiagnosticComponent, ImplicitTendencyComponent, Stepper,
    TendencyComponent, timestep_seconds)
from .dataarray import DataArray, common_backend
from .units import conversion_factor


class UpdateFrequencyWrapper:
    """Recompute the wrapped component only every ``update_timedelta`` of
    model time; otherwise return the cached output."""

    def __init__(self, component, update_timedelta):
        self.component = component
        self.update_timedelta = update_timedelta
        self._cached_output = None
        self._last_update_time = None

    @property
    def input_properties(self):
        return self.component.input_properties

    @property
    def tendency_properties(self):
        return getattr(self.component, 'tendency_properties', {})

    @property
    def diagnostic_properties(self):
        return getattr(self.component, 'diagnostic_properties', {})

    @property
    def output_properties(self):
        return getattr(self.component, 'output_properties', {})

    def __call__(self, state, timestep=None):
        time = state.get('time')
        due = (
            self._cached_output is None
            or self._last_update_time is None
            or time is None
            or time >= self._last_update_time + self.update_timedelta)
        if due:
            if isinstance(self.component,
                          (Stepper, ImplicitTendencyComponent)):
                self._cached_output = self.component(state, timestep)
            elif timestep is not None and not isinstance(
                    self.component, (TendencyComponent,
                                     DiagnosticComponent)):
                self._cached_output = self.component(state, timestep)
            else:
                self._cached_output = self.component(state)
            self._last_update_time = time
        return self._cached_output

    def __getattr__(self, item):
        return getattr(self.component, item)


class TimeDifferencingWrapper:
    """Wrap a Stepper as an ImplicitTendencyComponent.

    Tendency for each stepped quantity = (new_value - old_value) / dt; other
    outputs pass through as diagnostics.  Required because "Spectral
    dynamical cores step the model forward in spectral space"
    (CliMT's docs/configuration.rst:72-84).
    """

    def __init__(self, component):
        if not isinstance(component, Stepper):
            raise TypeError(
                'TimeDifferencingWrapper wraps Stepper components')
        self.component = component

    @property
    def input_properties(self):
        return self.component.input_properties

    @property
    def diagnostic_properties(self):
        return self.component.diagnostic_properties

    @property
    def tendency_properties(self):
        out = {}
        for name, spec in self.component.output_properties.items():
            new_spec = dict(spec)
            units = spec.get('units', '')
            new_spec['units'] = (units + ' s^-1').strip()
            out[name] = new_spec
        return out

    def __call__(self, state, timestep):
        dt = timestep_seconds(timestep)
        diagnostics, new_state = self.component(state, timestep)
        tendencies = {}
        for name, new_value in new_state.items():
            old = state[name]
            scale, shift = conversion_factor(old.units, new_value.units)
            old_values = old.values * scale
            if shift != 0.0:
                old_values = old_values + shift
            if old.dims != new_value.dims:
                old_values = DataArray(
                    old_values, old.dims).transpose(*new_value.dims).values
            new_values, old_values = common_backend(new_value.values,
                                                    old_values)
            tendencies[name] = DataArray(
                (new_values - old_values) / dt,
                new_value.dims,
                {'units': (new_value.units + ' s^-1').strip()},
                name)
        return tendencies, diagnostics

    def __getattr__(self, item):
        return getattr(self.component, item)


class ScalingWrapper:
    """Scale selected inputs, tendencies, diagnostics, or outputs of a
    wrapped component by constant factors."""

    def __init__(self, component, input_scale_factors=None,
                 tendency_scale_factors=None, diagnostic_scale_factors=None,
                 output_scale_factors=None):
        self.component = component
        self._input_factors = dict(input_scale_factors or {})
        self._tendency_factors = dict(tendency_scale_factors or {})
        self._diagnostic_factors = dict(diagnostic_scale_factors or {})
        self._output_factors = dict(output_scale_factors or {})
        for factors, props in (
                (self._input_factors, component.input_properties),
                (self._tendency_factors,
                 getattr(component, 'tendency_properties', {})),
                (self._diagnostic_factors,
                 getattr(component, 'diagnostic_properties', {})),
                (self._output_factors,
                 getattr(component, 'output_properties', {}))):
            for name in factors:
                if name not in props:
                    raise ValueError(
                        '{} is not a quantity of the wrapped '
                        'component'.format(name))

    @property
    def input_properties(self):
        return self.component.input_properties

    @property
    def tendency_properties(self):
        return getattr(self.component, 'tendency_properties', {})

    @property
    def diagnostic_properties(self):
        return getattr(self.component, 'diagnostic_properties', {})

    @property
    def output_properties(self):
        return getattr(self.component, 'output_properties', {})

    def _scaled_state(self, state):
        if not self._input_factors:
            return state
        scaled = dict(state)
        for name, factor in self._input_factors.items():
            value = state[name]
            scaled[name] = DataArray(
                value.values * factor, value.dims, dict(value.attrs), name)
        return scaled

    @staticmethod
    def _scale(output, factors):
        for name, factor in factors.items():
            if name in output:
                value = output[name]
                output[name] = DataArray(
                    value.values * factor, value.dims, dict(value.attrs),
                    name)
        return output

    def __call__(self, state, timestep=None):
        state = self._scaled_state(state)
        comp = self.component
        if isinstance(comp, Stepper):
            diagnostics, new_state = comp(state, timestep)
            return (self._scale(diagnostics, self._diagnostic_factors),
                    self._scale(new_state, self._output_factors))
        if isinstance(comp, ImplicitTendencyComponent) or (
                timestep is not None
                and not isinstance(comp, (TendencyComponent,
                                          DiagnosticComponent))):
            tendencies, diagnostics = comp(state, timestep)
            return (self._scale(tendencies, self._tendency_factors),
                    self._scale(diagnostics, self._diagnostic_factors))
        if isinstance(comp, TendencyComponent):
            tendencies, diagnostics = comp(state)
            return (self._scale(tendencies, self._tendency_factors),
                    self._scale(diagnostics, self._diagnostic_factors))
        diagnostics = comp(state)
        return self._scale(diagnostics, self._diagnostic_factors)

    def __getattr__(self, item):
        return getattr(self.component, item)
