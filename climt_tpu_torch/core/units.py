"""Minimal, dependency-free units engine.

A copy of climt_tpu/core/units.py (pure Python), so that this
package never imports the JAX one.

The reference framework (climt via sympl, see
CliMT's docs/interaction.rst "Model State") uses Pint-backed
units-aware DataArrays.  Pint is unavailable here and far heavier than what a
compiled model needs: all unit conversions in this framework are resolved to a
single (scale, offset) pair at graph-build time, so the per-step compute path
never touches unit strings.

Grammar (covers every unit string appearing in the reference tree):

    expr    := factor (sep factor)*
    sep     := '/' | '*' | whitespace          ('/' negates the next factor)
    factor  := NAME exponent?
    exponent:= '^' int | '**' int | signed int suffix (e.g. "m-2")

Examples: ``"W m^-2"``, ``"J kg^-1 degK^-1"``, ``"W/m^2/K^4"``, ``"mm day^-1"``,
``"degrees_north"``, ``"dimensionless"``.
"""

from __future__ import annotations

import re
from fractions import Fraction
from functools import lru_cache
from typing import Dict, NamedTuple, Tuple


class UnitError(ValueError):
    pass


# Base dimensions: length, mass, time, temperature, amount, angle
_NBASE = 6
_DIMLESS = (Fraction(0),) * _NBASE


def _dim(m=0, kg=0, s=0, K=0, mol=0, rad=0):
    return (Fraction(m), Fraction(kg), Fraction(s), Fraction(K),
            Fraction(mol), Fraction(rad))


class Unit(NamedTuple):
    """A resolved unit: value_in_SI = magnitude * scale + offset."""
    dims: Tuple[Fraction, ...]
    scale: float
    offset: float = 0.0  # only nonzero for offset temperature units (degC)

    @property
    def is_dimensionless(self):
        return self.dims == _DIMLESS


# name -> (dims, scale, offset). Scale converts TO coherent SI.
_UNIT_TABLE: Dict[str, Tuple[Tuple[Fraction, ...], float, float]] = {}


def _register(names, dims, scale, offset=0.0):
    for n in names:
        _UNIT_TABLE[n] = (dims, scale, offset)


_register(['m', 'meter', 'meters', 'metre', 'metres'], _dim(m=1), 1.0)
_register(['km', 'kilometer', 'kilometers'], _dim(m=1), 1e3)
_register(['cm'], _dim(m=1), 1e-2)
_register(['mm'], _dim(m=1), 1e-3)
_register(['um', 'µm', 'micrometer', 'micrometers', 'micron', 'microns'],
          _dim(m=1), 1e-6)
_register(['nm'], _dim(m=1), 1e-9)

_register(['kg', 'kilogram', 'kilograms'], _dim(kg=1), 1.0)
_register(['g', 'gram', 'grams'], _dim(kg=1), 1e-3)
_register(['mg'], _dim(kg=1), 1e-6)

_register(['s', 'sec', 'secs', 'second', 'seconds'], _dim(s=1), 1.0)
_register(['ms', 'millisecond', 'milliseconds'], _dim(s=1), 1e-3)
_register(['min', 'minute', 'minutes'], _dim(s=1), 60.0)
_register(['h', 'hr', 'hour', 'hours'], _dim(s=1), 3600.0)
_register(['day', 'days'], _dim(s=1), 86400.0)

_register(['K', 'degK', 'kelvin', 'degree_Kelvin', 'degrees_Kelvin',
           'degree_kelvin', 'degrees_kelvin'], _dim(K=1), 1.0)
_register(['degC', 'celsius', 'degree_Celsius', 'degrees_Celsius'],
          _dim(K=1), 1.0, 273.15)

_register(['mol', 'mole', 'moles'], _dim(mol=1), 1.0)

_register(['rad', 'radian', 'radians'], _dim(rad=1), 1.0)
_register(['deg', 'degree', 'degrees', 'degrees_north', 'degrees_N',
           'degrees_east', 'degrees_E', 'degree_north', 'degree_N',
           'degree_east', 'degree_E', 'degrees_south', 'degrees_west'],
          _dim(rad=1), 3.141592653589793 / 180.0)

_register(['Pa', 'pascal', 'pascals'], _dim(kg=1, m=-1, s=-2), 1.0)
_register(['hPa', 'mbar', 'millibar', 'mb'], _dim(kg=1, m=-1, s=-2), 100.0)
_register(['kPa'], _dim(kg=1, m=-1, s=-2), 1e3)
_register(['bar'], _dim(kg=1, m=-1, s=-2), 1e5)
_register(['atm', 'atmosphere'], _dim(kg=1, m=-1, s=-2), 101325.0)

_register(['J', 'joule', 'joules'], _dim(kg=1, m=2, s=-2), 1.0)
_register(['kJ'], _dim(kg=1, m=2, s=-2), 1e3)
_register(['W', 'watt', 'watts'], _dim(kg=1, m=2, s=-3), 1.0)
_register(['N', 'newton', 'newtons'], _dim(kg=1, m=1, s=-2), 1.0)
_register(['Hz', 'hertz'], _dim(s=-1), 1.0)

_register(['dimensionless', '1', ''], _DIMLESS, 1.0)
_register(['percent', '%'], _DIMLESS, 1e-2)
_register(['ppm'], _DIMLESS, 1e-6)
_register(['ppb'], _DIMLESS, 1e-9)
_register(['ppt'], _DIMLESS, 1e-12)

_FACTOR_RE = re.compile(
    r'([A-Za-z_%µμ]+)\s*(?:\^|\*\*)?\s*([+-]?\d+(?:/\d+)?)?$')


def _parse_factor(tok: str) -> Tuple[Tuple[Fraction, ...], float, float, int]:
    m = _FACTOR_RE.match(tok.strip())
    if not m:
        raise UnitError('Cannot parse unit factor {!r}'.format(tok))
    name, exp = m.group(1), m.group(2)
    if name not in _UNIT_TABLE:
        raise UnitError('Unknown unit {!r}'.format(name))
    dims, scale, offset = _UNIT_TABLE[name]
    e = int(Fraction(exp)) if exp else 1
    return dims, scale, offset, e


@lru_cache(maxsize=4096)
def parse_units(units: str) -> Unit:
    """Parse a unit string into a resolved Unit (dims, scale to SI, offset)."""
    if units is None:
        units = 'dimensionless'
    units = units.strip()
    if units in ('', 'dimensionless', '1'):
        return Unit(_DIMLESS, 1.0, 0.0)

    # expand parenthesized groups (one nesting level suffices for unit
    # strings): 'J/(degK*kg)' -> 'J/degK/kg', '(m*s)' -> 'm*s'
    def _div_group(m):
        # split on whitespace or a single '*' — a '**' exponent stays
        # bound to its unit ('kg/(m**2*s)' -> '/m**2/s')
        inner = re.split(r'\s+|(?<!\*)\*(?!\*)', m.group(1).strip())
        return ''.join('/' + tok for tok in inner if tok)
    units = re.sub(r'/\s*\(([^()]*)\)', _div_group, units)
    units = re.sub(r'\(([^()]*)\)', r'\1', units)

    # Tokenize into (sign, factor) where '/' flips the sign of the next factor
    dims = [Fraction(0)] * _NBASE
    scale = 1.0
    offset = 0.0
    n_offset_factors = 0
    total_factors = 0

    # split on '/' first (pint semantics: each '/' applies to the following
    # product group of exactly one factor, matching 'W/m^2/K^4')
    parts = re.split(r'(/)', units)
    sign = 1
    for part in parts:
        part = part.strip()
        if part == '/':
            sign = -1
            continue
        if not part:
            continue
        # within a part, factors are separated by whitespace or a single
        # '*'; '**' (and '^') bind an exponent to the preceding unit, so
        # collapse any spacing around them first ('W/m**2', 'm ** 2')
        part = re.sub(r'\s*\*\*\s*', '**', part)
        part = re.sub(r'\s*\^\s*', '^', part)
        for tok in re.split(r'\s+|(?<!\*)\*(?!\*)', part):
            if not tok:
                continue
            fdims, fscale, foffset, e = _parse_factor(tok)
            e *= sign
            for i in range(_NBASE):
                dims[i] += fdims[i] * e
            scale *= fscale ** e
            total_factors += 1
            if foffset != 0.0:
                n_offset_factors += 1
                offset = foffset
            # '/' only applies to the single factor immediately after it
            sign = 1 if sign == -1 and tok is not None else sign

    if n_offset_factors and (total_factors > 1 or n_offset_factors > 1):
        # offset units only valid standalone (like pint's delta handling)
        offset = 0.0
    return Unit(tuple(dims), scale, offset)


def units_are_compatible(from_units: str, to_units: str) -> bool:
    try:
        return parse_units(from_units).dims == parse_units(to_units).dims
    except UnitError:
        return False


def units_are_same(units1: str, units2: str) -> bool:
    u1, u2 = parse_units(units1), parse_units(units2)
    return (u1.dims == u2.dims
            and abs(u1.scale / u2.scale - 1.0) < 1e-12
            and u1.offset == u2.offset)


@lru_cache(maxsize=4096)
def conversion_factor(from_units: str, to_units: str) -> Tuple[float, float]:
    """Return (scale, shift) with value_to = value_from * scale + shift."""
    f, t = parse_units(from_units), parse_units(to_units)
    if f.dims != t.dims:
        raise UnitError(
            'Cannot convert from {!r} to {!r}: incompatible dimensions'.format(
                from_units, to_units))
    scale = f.scale / t.scale
    shift = (f.offset - t.offset) / t.scale
    return scale, shift


def convert(value, from_units: str, to_units: str):
    """Convert a scalar or array from one unit to another."""
    scale, shift = conversion_factor(from_units, to_units)
    if scale == 1.0 and shift == 0.0:
        return value
    out = value * scale
    if shift != 0.0:
        out = out + shift
    return out


def clean_units(units: str) -> str:
    """Normalize a unit string (identity here; kept for API parity)."""
    parse_units(units)
    return units


def is_valid_unit(units: str) -> bool:
    try:
        parse_units(units)
        return True
    except UnitError:
        return False
