"""The taumol term writer: one CUDA launch writes every term of one taumol
call's kernel-B groups.

taumol (``lw_spectral.taumol_lw_terms``, ``sw_spectral.taumol_sw_terms``)
turns setcoef's per-cell coefficients into the int32 row index and the
weight of every term that kernel B (``fused_mix``) then sums: the key
species' 2x2x2 corners, the continua, the minor gases, the cross-sections,
the Planck fractions, the Rayleigh depths and the solar source.  Their
PyTorch writers (``taumol_lw_terms_plain``, ``taumol_sw_terms_plain``)
write each term with a few elementwise operations over the (nz, ncol)
cells: about 1,900 launches an LW call and 1,500 an SW call, each a few
microseconds of device work behind ten or more of host dispatch.  On the
card ``csrc/taumol_terms.cu`` writes them all in one launch per call.

TPU kernel replaced: none.  The JAX package writes these terms with XLA,
which fuses the elementwise arithmetic into a few kernels
(climt_tpu/components/rrtmg/lw_spectral.py:396, sw_spectral.py:247); the
port's PyTorch dispatches every operation alone, so the kernel does here
what XLA's fusion does there.

What the kernel reads is a ``TermPlan``: the PyTorch writer's walk over the
band table (``BANDS_LW``, ``BANDS``) recorded instead of computed, by
``lw_spectral.lw_term_plan`` and ``sw_spectral.sw_term_plan``.  It holds
each group's bands and parts, which ``fused_mix.Group.declare`` hands to
kernel B's layout, and a list of entries, one step of the walk each (a
band's key-species corners, one ``lin`` pair, one ``row``, a band's
pressure correction or solar reference layer), with the fields it reads
and its constants.  Which entries exist depends on the tables the source
holds, the cross-section gases and each ``fracref``'s rank, never on table
values: a plan is cached under its key and source, as ``fused_mix.Layout``
is, and tables that require grad (the calibration's, packed anew on every
call) take the kernel too.  Per call the host passes the fields' pointers
and strides and the solar factors in the launch's parameter block.

Bound on the card: bytes.  One thread per cell (one per column for the
solar source) evaluates every entry in order and stores each term's index
and weight, coalesced along cells; the fields are read once from device
memory, and a one-row table's term stores its weight alone (kernel B reads
no index there).  The arithmetic is the PyTorch writer's, operation by
operation and in its order, built with ``-fmad=false``; divisions by a
constant divide, as PyTorch does on the CPU (on the card PyTorch multiplies
by the reciprocal).  The power of the adjusted minor-gas columns is the
one difference: the float32 kernel rounds the float64 ``pow`` of its
arguments, PyTorch's CPU vector path takes SLEEF's ``powf``, which may
differ by an ulp.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _build
from .fused_mix import _requires_grad

# entry kinds: keep in step with csrc/taumol_terms.cu's Kind
KIND = dict(lw_band=1, lw_key=2, lw_self=3, lw_for=4, lw_minor=5, lw_wx=6,
            frac_row=7, frac_lin=8, sw_key=9, sw_self=10, sw_for=11,
            row_col=12, row_o2=13, lin_eta=14, sol_layer=15, sol_row=16,
            sol_lin=17)
# ints per entry: kind, group, first term, NPARAM parameters, first
# constant
RECORD = 16
NPARAM = RECORD - 4
# the kernel's limits (csrc/taumol_terms.cu): float and int fields, groups
# and solar factors of one launch
MAX_FLOAT_FIELDS, MAX_INT_FIELDS, MAX_GROUPS, MAX_FACTORS = 48, 12, 3, 48
# fields every key-species entry reads, at these ids
CORE_FLOAT = ('fac00', 'fac10', 'fac01', 'fac11')
CORE_INT = ('jp', 'jp0', 'jt0', 'jt10')
# weight masks of an entry: none, the troposphere, above it
NO_MASK, TROP, UPPER = 0, 1, 2


class TermPlan:
    """The entries of one taumol call's groups (see the module docstring).

    A builder opens each group's bands with ``band(g, ng)`` and parts with
    ``part(g, table)``, as the PyTorch writer does on a ``fused_mix.Group``,
    and adds the entries that write the current part's terms with
    ``entry``; ``field``/``int_field`` give a cell field's id.  Groups
    listed in ``columns`` hold one cell per column (the solar source)."""

    def __init__(self, ngroups, columns=()):
        self.ngs = [[] for _ in range(ngroups)]
        self.parts = [[] for _ in range(ngroups)]
        self.nterms = [0] * ngroups
        self.columns = frozenset(columns)
        self.records, self.consts = [], []
        self.fields, self.int_fields = list(CORE_FLOAT), list(CORE_INT)
        self.source = None
        self.device_form = None

    def band(self, g, ng):
        self.ngs[g].append(ng)

    def part(self, g, table):
        self.parts[g].append([len(self.ngs[g]) - 1, table, 0])

    def field(self, name):
        if name not in self.fields:
            self.fields.append(name)
        return self.fields.index(name)

    def int_field(self, name):
        if name not in self.int_fields:
            self.int_fields.append(name)
        return self.int_fields.index(name)

    def entry(self, kind, g, params=(), consts=(), nterms=0):
        """One entry of ``kind`` writing ``nterms`` terms of group ``g``'s
        current part, with int ``params`` and float ``consts``."""
        params = list(params)
        if len(params) > NPARAM:
            raise ValueError('term plan: %d parameters for %s' % (
                len(params), kind))
        self.records.append([KIND[kind], g, self.nterms[g]] + params
                            + [0] * (NPARAM - len(params))
                            + [len(self.consts)])
        self.consts.extend(float(c) for c in consts)
        if nterms:
            self.parts[g][-1][2] += nterms
            self.nterms[g] += nterms

    @property
    def requires_grad(self):
        return _requires_grad(t for parts in self.parts for _, t, _ in parts)

    def finish(self, dtype, device):
        """The plan's device form: its records, those of the cell groups
        first, as (entries, RECORD) int32, and its constants in ``dtype``."""
        cell = [r for r in self.records if r[1] not in self.columns]
        col = [r for r in self.records if r[1] in self.columns]
        if (len(self.fields) > MAX_FLOAT_FIELDS
                or len(self.int_fields) > MAX_INT_FIELDS
                or len(self.ngs) > MAX_GROUPS):
            raise ValueError('term plan: %d float fields, %d int fields, %d '
                             'groups exceed the kernel\'s limits' % (
                                 len(self.fields), len(self.int_fields),
                                 len(self.ngs)))
        records = torch.as_tensor(np.asarray(cell + col, np.int32).reshape(
            -1, RECORD), device=device)
        consts = torch.as_tensor(np.asarray(self.consts + [0.0]),
                                 dtype=dtype, device=device)
        self.device_form = (records, len(cell), len(col), consts)
        return self


_PLANS = {}


def cached_plan(key, source, dtype, device, build):
    """The plan cached under (``key``, dtype, device) when it was built
    from ``source`` (compared by identity, as ``fused_mix.Group`` compares
    a layout's), else ``build()``'s, cached unless its tables require
    grad."""
    full = (key, dtype, str(torch.device(device)))
    plan = _PLANS.get(full)
    if plan is not None and plan.source is source:
        return plan
    plan = build().finish(dtype, device)
    plan.source = source
    if not plan.requires_grad:
        _PLANS[full] = plan
    return plan


_ENTRY = {torch.float32: 'climt_taumol_terms_f32',
          torch.float64: 'climt_taumol_terms_f64'}


def taumol_terms_cuda(plan, groups, fields, chi=None, factors=()):
    """Launch ``csrc/taumol_terms.cu`` once: write every term of
    ``groups`` (the plan's ``fused_mix.Group`` of each group, in order)
    into their (terms, *cells) index and weight pair.  ``fields`` maps
    each of the plan's field names to a (nz, ncol) tensor on one CUDA
    device, floats in the groups' type (float32 or float64) and ints
    int32, each with unit stride along columns; ``fields['trop']`` is the
    boolean troposphere mask.  ``chi`` is setcoef's (rows, levels) chi_mls
    table, which the adjusted minor-gas columns read; ``factors`` the solar
    source's factors, by slot."""
    trop = fields['trop']
    dtype, dev = groups[0].dtype, trop.device
    if dtype not in _ENTRY:
        raise TypeError('taumol_terms_cuda takes float32 or float64 groups, '
                        'got %s' % dtype)
    if not trop.is_cuda:
        raise ValueError('taumol_terms_cuda: the fields must be on a CUDA '
                         'device')
    if (trop.dim() != 2 or trop.dtype != torch.bool
            or trop.stride(1) != 1):
        raise ValueError('taumol_terms_cuda: trop must be a (nz, ncol) bool '
                         'tensor with unit column stride')
    if len(groups) != len(plan.ngs):
        raise ValueError('taumol_terms_cuda: %d groups for a plan of %d'
                         % (len(groups), len(plan.ngs)))
    nz, ncol = trop.shape
    grad = torch.is_grad_enabled()
    keep = []

    def pointer(name, want):
        x = fields[name]
        if x.dtype != want or x.device != dev or x.shape != trop.shape:
            raise ValueError('taumol_terms_cuda: field %s is %s %s on %s, '
                             'expected %s %s on %s' % (
                                 name, x.dtype, tuple(x.shape), x.device,
                                 want, tuple(trop.shape), dev))
        if grad and x.requires_grad:
            raise NotImplementedError(
                'taumol_terms_cuda has no gradient: field %s requires grad'
                % name)
        if x.stride(1) != 1:
            x = x.contiguous()
            keep.append(x)
        return [x.data_ptr(), x.stride(0)]

    records, ncell_rec, ncol_rec, consts = plan.device_form
    if consts.dtype != dtype or consts.device != dev:
        raise ValueError('taumol_terms_cuda: a plan for %s on %s, groups of '
                         '%s on %s' % (consts.dtype, consts.device, dtype,
                                       dev))
    if len(factors) > MAX_FACTORS:
        raise ValueError('taumol_terms_cuda: %d solar factors, at most %d'
                         % (len(factors), MAX_FACTORS))
    if chi is not None and (chi.dtype != dtype or chi.device != dev
                            or chi.dim() != 2 or chi.stride(1) != 1):
        raise ValueError('taumol_terms_cuda: chi must be a 2-D %s table on '
                         '%s with unit column stride' % (dtype, dev))
    idx = [0] * MAX_GROUPS
    w = [0] * MAX_GROUPS
    for g, group in enumerate(groups):
        group.declare(plan.ngs[g], plan.parts[g])
        _, gi, gw = group.finish()
        cells = (ncol,) if g in plan.columns else (nz, ncol)
        if tuple(gi.shape) != (plan.nterms[g],) + cells:
            raise ValueError('taumol_terms_cuda: group %d holds %s, its plan '
                             '%d terms of %s cells' % (
                                 g, tuple(gi.shape), plan.nterms[g], cells))
        idx[g], w[g] = gi.data_ptr(), gw.data_ptr()
    args = [nz, ncol, len(plan.fields), len(plan.int_fields), ncell_rec,
            ncol_rec, records.data_ptr(), consts.data_ptr(),
            trop.data_ptr(), trop.stride(0)]
    args += ([chi.data_ptr(), chi.stride(0)] if chi is not None else [0, 0])
    args += idx + w + [len(factors)]
    for name in plan.fields:
        args += pointer(name, dtype)
    for name in plan.int_fields:
        args += pointer(name, torch.int32)
    a = (ctypes.c_longlong * len(args))(*args)
    f = (ctypes.c_double * max(1, len(factors)))(*map(float, factors))
    rc = getattr(_build.library(), _ENTRY[dtype])(
        ctypes.addressof(a), ctypes.addressof(f),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, 'taumol_terms_cuda')
    taumol_terms_cuda.launches += 1
    return groups


# launches of the kernel, and term groups written on the card by the
# PyTorch writers instead (``taumol_*_terms_plain`` with CUDA tensors).
# taumol_lw_terms / taumol_sw_terms send every CUDA tensor to the kernel,
# so the program's own path keeps fallbacks at 0; it counts only callers
# that call the PyTorch writers on the card directly, such as the card
# tests' references, and shows one if a caller goes round the dispatch
taumol_terms_cuda.launches = 0
taumol_terms_cuda.fallbacks = 0

