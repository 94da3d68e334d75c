"""Time steppers that wrap lists of TendencyComponents
(climt_tpu/core/steppers.py).

Mirrors the contract of the reference's ``sympl.TendencyStepper`` /
``AdamsBashforth`` (used at CliMT's examples/radiative_equilibrium.py:26-36
and CliMT's tests/test_components.py:164): ``__call__(state, timestep)
-> (diagnostics, new_state)``; the first call is a forward-Euler step, after
which the multi-step Adams-Bashforth weights apply.

The classes aggregate labeled DataArrays whose values are numpy arrays or
torch tensors; where a state's numpy array meets a component's tensor,
``common_backend`` moves the numpy side to the tensor's device, so the
stepped quantities come back as tensors.
"""

from __future__ import annotations

from .base_components import (
    ImplicitTendencyComponent, TendencyComponent, timestep_seconds)
from .dataarray import DataArray, common_backend
from .units import conversion_factor


class TendencyStepper:
    """Base: steps a state using tendencies from wrapped components."""

    def __init__(self, *args, **kwargs):
        if len(args) == 1 and isinstance(args[0], (list, tuple)):
            components = list(args[0])
        else:
            components = list(args)
        for comp in components:
            if not isinstance(comp, (TendencyComponent,
                                     ImplicitTendencyComponent)):
                raise TypeError(
                    'TendencyStepper requires TendencyComponent instances, '
                    'got {}'.format(type(comp)))
        self.components = components
        self.name = kwargs.pop('name', self.__class__.__name__.lower())

    @property
    def input_properties(self):
        combined = {}
        for comp in self.components:
            for name, spec in comp.input_properties.items():
                combined.setdefault(name, spec)
        # quantities stepped must also be inputs
        for comp in self.components:
            for name, spec in comp.tendency_properties.items():
                combined.setdefault(name, _integrated_spec(name, spec, comp))
        return combined

    def get_tendencies(self, state, timestep=None):
        """Sum tendencies over components; merge diagnostics."""
        total = {}
        units = {}
        diagnostics = {}
        for comp in self.components:
            if isinstance(comp, ImplicitTendencyComponent):
                tendencies, diag = comp(state, timestep)
            else:
                tendencies, diag = comp(state)
            diagnostics.update(diag)
            for name, value in tendencies.items():
                if name in total:
                    value = value.to_units(units[name])
                    if value.dims != total[name].dims:
                        # components may emit different dim orders (e.g.
                        # ['mid_levels','*'] vs ['*','mid_levels']); align
                        # by name before summing or broadcasting corrupts
                        # the array
                        value = value.transpose(*total[name].dims)
                    a, b = common_backend(total[name].values, value.values)
                    total[name] = DataArray(
                        a + b,
                        total[name].dims, total[name].attrs, name)
                else:
                    total[name] = value
                    units[name] = value.units
        return total, diagnostics

    def __call__(self, state, timestep):
        raise NotImplementedError


def _integrated_spec(name, tendency_spec, comp):
    spec = {'units': _integrate_units(tendency_spec.get('units', ''))}
    if 'dims' in tendency_spec:
        spec['dims'] = tendency_spec['dims']
    elif name in comp.input_properties and 'dims' in comp.input_properties[name]:
        spec['dims'] = comp.input_properties[name]['dims']
    return spec


def _integrate_units(units):
    """'degK s^-1' -> 'degK' etc. (multiply by seconds)."""
    for suffix in (' s^-1', ' s**-1', '/s', ' s-1'):
        if units.endswith(suffix):
            return units[:-len(suffix)]
    return units + ' s'


def _step_state(state, increments_seconds, dt=None):
    """new = state + sum_i coeff_i * tendency_i, with unit handling.

    ``increments_seconds``: list of (tendency_dict, coefficient_seconds).
    """
    new_state = {}
    for name in increments_seconds[0][0].keys():
        old = state[name]
        increment = None
        for tendencies_i, coeff in increments_seconds:
            t = tendencies_i[name]
            # express the tendency in (state units) per second
            scale, _ = conversion_factor(t.units, old.units + ' s^-1')
            inc = t.values * (scale * coeff)
            if increment is None:
                increment = inc
            else:
                increment, inc = common_backend(increment, inc)
                increment = increment + inc
        # tendency raw layout may differ from the state's host layout; align
        t0 = increments_seconds[0][0][name]
        if t0.dims != old.dims:
            aligned = DataArray(increment, t0.dims).transpose(*old.dims)
            increment = aligned.values
        old_values, increment = common_backend(old.values, increment)
        new_state[name] = DataArray(
            old_values + increment, old.dims, dict(old.attrs), name)
    # untouched quantities pass through to the new state (the contract the
    # reference's stepping caches encode: new_state is the full state with
    # stepped quantities replaced)
    for name, value in state.items():
        if name not in new_state:
            new_state[name] = value
    return new_state


class AdamsBashforth(TendencyStepper):
    """Adams-Bashforth integrator of order up to 3.

    Starts with forward Euler, then AB2, then AB3 (matching the startup
    behavior the reference's cached ``*_stepping`` outputs encode, which are
    single Euler steps: CliMT's tests/test_components.py:161-208).
    """

    def __init__(self, *args, **kwargs):
        self.order = kwargs.pop('order', 3)
        if not 1 <= self.order <= 4:
            raise ValueError('order must be between 1 and 4')
        super().__init__(*args, **kwargs)
        self._history = []  # most recent first

    def __call__(self, state, timestep):
        dt = timestep_seconds(timestep)
        tendencies, diagnostics = self.get_tendencies(state, timestep)
        self._history.insert(0, tendencies)
        if len(self._history) > self.order:
            self._history.pop()
        coeffs = _AB_COEFFICIENTS[len(self._history)]
        increments = [(tend, c * dt)
                      for tend, c in zip(self._history, coeffs)]
        new_state = _step_state(state, increments, dt)
        return diagnostics, new_state


_AB_COEFFICIENTS = {
    1: (1.0,),
    2: (1.5, -0.5),
    3: (23. / 12., -16. / 12., 5. / 12.),
    4: (55. / 24., -59. / 24., 37. / 24., -9. / 24.),
}


class Leapfrog(TendencyStepper):
    """Leapfrog integrator with Robert-Asselin filtering.

    x_{n+1} = x_{n-1} + 2 dt T(x_n); the filter damps the computational mode:
    x_n <- x_n + alpha (x_{n+1} - 2 x_n + x_{n-1}).
    """

    def __init__(self, *args, **kwargs):
        self.asselin_strength = kwargs.pop('asselin_strength', 0.05)
        super().__init__(*args, **kwargs)
        self._previous = None

    def __call__(self, state, timestep):
        dt = timestep_seconds(timestep)
        tendencies, diagnostics = self.get_tendencies(state, timestep)
        if self._previous is None:
            increments = [(tendencies, dt)]
            new_state = _step_state(state, increments, dt)
        else:
            increments = [(tendencies, 2.0 * dt)]
            new_state = _step_state(self._previous, increments, dt)
            alpha = self.asselin_strength
            for name in new_state:
                # 'time' and other non-array entries pass through
                # unfiltered; the JAX Leapfrog (steppers.py:189) reads
                # .values of every entry and fails on a state with 'time'
                if not isinstance(new_state[name], DataArray):
                    continue
                now, new, prev = common_backend(
                    state[name].values, new_state[name].values,
                    self._previous[name].values)
                filt = now + alpha * (new - 2.0 * now + prev)
                state[name] = DataArray(
                    filt, state[name].dims, dict(state[name].attrs), name)
        self._previous = {
            name: state.get(name, new_state[name]) for name in new_state}
        return diagnostics, new_state


class SSPRungeKutta(TendencyStepper):
    """Strong-stability-preserving RK3 (Shu-Osher) for explicit stepping."""

    def __call__(self, state, timestep):
        dt = timestep_seconds(timestep)
        t1, diagnostics = self.get_tendencies(state, timestep)
        s1 = dict(state)
        s1.update(_step_state(state, [(t1, dt)], dt))
        t2, _ = self.get_tendencies(s1, timestep)
        s2 = dict(state)
        blended = {}
        for name in t2:
            a, b = common_backend(t1[name].values, t2[name].values)
            blended[name] = DataArray(
                0.25 * (a + b),
                t1[name].dims, dict(t1[name].attrs), name)
        s2.update(_step_state(state, [(blended, 2.0 * dt)], dt))
        t3, _ = self.get_tendencies(s2, timestep)
        final = {}
        for name in t3:
            a, b, c = common_backend(t1[name].values, t2[name].values,
                                     t3[name].values)
            final[name] = DataArray(
                (a + b + 4.0 * c) / 6.0,
                t1[name].dims, dict(t1[name].attrs), name)
        new_state = _step_state(state, [(final, dt)], dt)
        return diagnostics, new_state
