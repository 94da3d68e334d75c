"""Bytes and operations that RRTMG's gas optics (kernel B) and LW flux
sweep (kernel A) need, and the floating-point work of one LW+SW call,
from the call's shape (layers, columns) and the RRTMG data files.

What is counted is what the algorithm needs, each input read once and
each output written once, in float32 (4 bytes).  It is frozen here: a
change to how the program packs its tables or splits taumol's arithmetic
from the kernels does not move it.

Kernel B (the table gather-sum of the gas optics; six outputs a call):
  in   the layer profiles the interpolation is computed from, six floats
       a layer (pressure, temperature, and the H2O, O3, CO2 and O2
       amounts) for the LW and again for the SW; the temperatures of the
       layers, levels and surface for the Planck functions; and the
       k-tables once: every array of the LW k-distribution, the SW
       k-distribution's gas tables (its ``aer_*`` aerosol tables are not
       gas optics) and the LW support's ``totplnk``;
  out  LW taug and Planck fractions (layers x columns x 140), SW taug
       and Rayleigh optical depth (layers x columns x 112), the SW solar
       source (columns x 112), and the Planck functions of the layers,
       levels and surface (16 bands each).
  Not counted: the index and weight arrays that the program's taumol
  hands across to the kernel, which a kernel that folds that arithmetic
  in would never read.

Kernel A (the LW flux sweep, clear sky, analytic transmittance):
  in   taug and fracs (layers x columns x 140), the Planck functions of
       the layers and levels (x 16 bands), the surface Planck function
       and emissivity (columns x 16);
  out  the four flux profiles (levels x columns);
  or the sweeps' operations, 80 a (column, layer, g-point) (the layer
  terms, the two recurrences and the exponential), where they bound it
  more; the bytes do at every shape a cell runs.

FLOPs of a call: the LW sweep at 80 and the SW two-stream solver at 100
operations a (column, layer, g-point) (``reftra``'s coefficients, about
70 with one operation for each exp, sqrt and division, and the adding
method's two passes, about 30).  Gas optics, setcoef and the flux
integration over g-points are not counted.
"""

from __future__ import annotations

import functools
import os

import numpy as np

F32 = 4
LW_G = 140
SW_G = 112
LW_BANDS = 16
RTRN_OPS_PER_POINT = 80
SW_SOLVER_OPS_PER_POINT = 100

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), 'climt_tpu', 'data')


@functools.lru_cache()
def table_elements():
    """Elements of the k-tables kernel B reads: the LW k-distribution the
    program would load (the AER drop-in where it exists, else the
    surrogate), the SW k-distribution's gas tables, and ``totplnk``."""
    def count(name, keep=lambda k: True):
        with np.load(os.path.join(DATA_DIR, name)) as f:
            return sum(f[k].size for k in f.files if keep(k))

    aer = 'rrtmg_lw_kdist_aer.npz'
    lw = aer if os.path.exists(os.path.join(DATA_DIR, aer)) else \
        'rrtmg_lw_kdist_surrogate.npz'
    return (count(lw)
            + count('rrtmg_sw_kdist.npz', lambda k: not k.startswith('aer_'))
            + count('rrtmg_lw_support.npz', lambda k: k == 'totplnk'))


def kernel_b_bytes(nz, ncol, tables=None):
    """Bytes kernel B needs for one LW+SW call of ``nz`` layers and
    ``ncol`` columns."""
    tables = table_elements() if tables is None else tables
    cells = nz * ncol
    inputs = 2 * 6 * cells + (nz + (nz + 1) + 1) * ncol
    outputs = (2 * cells * LW_G + 2 * cells * SW_G + ncol * SW_G
               + (nz + (nz + 1) + 1) * ncol * LW_BANDS)
    return F32 * (inputs + outputs + tables)


def kernel_a_bytes(nz, ncol):
    """Bytes kernel A needs for one LW call."""
    inputs = (2 * nz * ncol * LW_G + (nz + (nz + 1)) * ncol * LW_BANDS
              + 2 * ncol * LW_BANDS)
    outputs = 4 * (nz + 1) * ncol
    return F32 * (inputs + outputs)


def kernel_a_flops(nz, ncol):
    return RTRN_OPS_PER_POINT * LW_G * nz * ncol


def call_flops(nz, ncol):
    """Counted floating-point operations of one LW+SW call."""
    return (kernel_a_flops(nz, ncol)
            + SW_SOLVER_OPS_PER_POINT * SW_G * nz * ncol)
