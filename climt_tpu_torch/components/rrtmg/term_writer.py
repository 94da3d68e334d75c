"""The taumol term writer: the plan of one taumol call's kernel-B terms,
written by one CUDA launch on the card and by its plain version elsewhere.

taumol (``lw_spectral.taumol_lw_terms``, ``sw_spectral.taumol_sw_terms``)
turns setcoef's per-cell coefficients into the int32 row index and the
weight of every term that kernel B (``fused_mix``) then sums: the key
species' 2x2x2 corners, the continua, the minor gases, the cross-sections,
the Planck fractions, the Rayleigh depths and the solar source.  Written
with PyTorch's elementwise operations over the (nz, ncol) cells they take
about 1,900 launches an LW call and 1,500 an SW call, each a few
microseconds of device work behind ten or more of host dispatch; on the
card ``csrc/taumol_terms.cu`` writes them all in one launch per call.

TPU kernel replaced: none.  The JAX package writes these terms with XLA,
which fuses the elementwise arithmetic into a few kernels
(climt_tpu/components/rrtmg/lw_spectral.py:396, sw_spectral.py:247); the
port's PyTorch dispatches every operation alone, so the kernel does here
what XLA's fusion does there.

The band table (``BANDS_LW``, ``BANDS``) is walked once, by
``lw_spectral.lw_term_plan`` and ``sw_spectral.sw_term_plan``, into a
``TermPlan``.  It holds each group's bands and parts, which
``fused_mix.Group.declare`` hands to kernel B's layout, and a list of
entries, one step of the walk each (a band's key-species corners, one
interpolated pair, one one-row term, a band's pressure correction or solar
reference layer), with the fields it reads and its constants.  Which
entries exist depends on the tables the source holds, the cross-section
gases and each ``fracref``'s rank, never on table values: a plan is cached
under its key and source, as ``fused_mix.Layout`` is, and tables that
require grad (the calibration's, packed anew on every call) take the
kernel too.  ``taumol_terms`` evaluates a plan: ``taumol_terms_cuda``
launches the kernel for CUDA fields, passing the fields' pointers and
strides and the solar factors in the launch's parameter block;
``taumol_terms_plain``, the plain version, runs the same entries in
PyTorch for CPU fields and is the kernel's test oracle.

Bound on the card: bytes.  One thread per cell (one per column for the
solar source) evaluates every entry in order and stores each term's index
and weight, coalesced along cells; the fields are read once from device
memory, and a one-row table's term stores its weight alone (kernel B reads
no index there).  The arithmetic is the plain version's, operation by
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
    ``part(g, table)``, as a caller does on a ``fused_mix.Group``, and
    adds the entries that write the current part's terms with
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
    for g, (gi, gw) in enumerate(_declared(plan, groups, (nz, ncol),
                                           'taumol_terms_cuda')):
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


# launches of the kernel
taumol_terms_cuda.launches = 0


def _declared(plan, groups, shape, who):
    """Declare each of ``groups``' bands and parts from ``plan``, as kernel
    B's layout takes them, and return their (terms, *cells) index and
    weight pairs, unwritten, for (nz, ncol) = ``shape`` cells."""
    if len(groups) != len(plan.ngs):
        raise ValueError('%s: %d groups for a plan of %d'
                         % (who, len(groups), len(plan.ngs)))
    nz, ncol = shape
    pairs = []
    for g, group in enumerate(groups):
        group.declare(plan.ngs[g], plan.parts[g])
        _, gi, gw = group.finish()
        cells = (ncol,) if g in plan.columns else (nz, ncol)
        if tuple(gi.shape) != (plan.nterms[g],) + cells:
            raise ValueError('%s: group %d holds %s, its plan %d terms of %s '
                             'cells' % (who, g, tuple(gi.shape),
                                        plan.nterms[g], cells))
        pairs.append((gi, gw))
    return pairs


_KIND_NAME = {v: k for k, v in KIND.items()}


def _eta(parm, n):
    """The eta index and fraction: n * clamp(parm, max=1 - 1e-6), truncated
    and its remainder."""
    mult = n * torch.clamp(parm, max=1.0 - 1.0e-6)
    js = torch.trunc(mult).to(torch.int32)
    return js, mult - js


def _last(cond, default):
    """Per column, the last level where ``cond`` holds, else ``default``."""
    k = torch.arange(cond.shape[0], device=cond.device)[:, None]
    last = torch.where(cond, k, -1).amax(0)
    return torch.where(last >= 0, last, default)


def taumol_terms_plain(plan, groups, fields, chi=None, factors=()):
    """The plain version of ``taumol_terms_cuda``, with its arguments and
    its result, on any device: the plan's entries evaluated in PyTorch one
    after another, each with the kernel's arithmetic in its order, each
    writing whole (nz, ncol) or (ncol,) terms.  Its indices and weights are
    the kernel's but for the power of the adjusted minor-gas columns (see
    the module docstring); a one-row part's term gets its weight alone."""
    trop = fields['trop']
    nz, ncol = trop.shape
    pairs = _declared(plan, groups, (nz, ncol), 'taumol_terms_plain')
    if torch.is_grad_enabled():
        for name in plan.fields:
            if fields[name].requires_grad:
                raise NotImplementedError(
                    'taumol_terms_plain has no gradient: field %s requires '
                    'grad' % name)
    F = [fields[name] for name in plan.fields]
    I = [fields[name] for name in plan.int_fields]
    jp, jp0, jt0, jt10 = I[:4]
    fac = ((F[0], F[1]), (F[2], F[3]))
    trop_f = trop.to(groups[0].dtype)
    mask_f = {TROP: trop_f, UPPER: 1.0 - trop_f}
    corr = js_sol = fs_sol = None

    def masked(x, mask):
        if mask == NO_MASK:
            return x
        return torch.where(trop if mask == TROP else ~trop, x, 0.0)

    def times_mask(x, mask):
        return x if mask == NO_MASK else x * mask_f[mask]

    def scaled(x):
        return x if corr is None else x * corr

    for rec in plan.records:
        kind, g, t = _KIND_NAME[rec[0]], rec[1], rec[2]
        p, c = rec[3:3 + NPARAM], plan.consts[rec[-1]:]
        idx, w = pairs[g]

        def lin(i, frac, weight=None):
            # fused_mix's two terms of a linear interpolation
            idx[t], idx[t + 1] = i, i + 1
            if weight is None:
                w[t], w[t + 1] = 1.0 - frac, frac
            else:
                w[t], w[t + 1] = (1.0 - frac) * weight, frac * weight

        if kind == 'lw_band':
            # taugb1/taugb2's pressure correction, folded into the weights
            pavel = F[p[1]]
            if p[0] == 1:
                lo = torch.where(pavel < 250.0,
                                 1.0 - 0.15 * (250.0 - pavel) / 154.4, 1.0)
                corr = torch.where(trop, lo, 1.0 - 0.15 * (pavel / 95.6))
            elif p[0] == 2:
                corr = torch.where(trop, 1.0 - 0.05 * (pavel - 100.0) / 900.0,
                                   torch.ones_like(pavel))
            else:
                corr = None
        elif kind in ('lw_key', 'sw_key'):
            lw = kind == 'lw_key'
            nspa, nspb, rows_a = p[:3]
            # per side (lower, upper): speccomb at jp and jp+1, its eta
            # index and fraction, or None where the side is absent
            sides = []
            for s, n_eta in ((0, 8), (1, 4)):
                c1, c2 = (p[3 + 4 * s:5 + 4 * s] if lw
                          else p[3 + 2 * s:5 + 2 * s])
                if c1 < 0:
                    sides.append(None)
                    continue
                x1 = F[c1]
                if c2 < 0:
                    sc, js, fs = (x1, x1), (0, 0), (torch.zeros_like(x1),) * 2
                elif lw:
                    sc = (x1 + F[p[5 + 4 * s]] * F[c2],
                          x1 + F[p[6 + 4 * s]] * F[c2])
                    (js0, fs0), (js1, fs1) = (_eta(x1 / x, n_eta) for x in sc)
                    js, fs = (js0, js1), (fs0, fs1)
                else:
                    sc = (x1 + c[s] * F[c2],) * 2
                    js0, fs0 = _eta(x1 / sc[0], n_eta)
                    js, fs = (js0, js0), (fs0, fs0)
                if not lw and s == 1 and p[7]:
                    sc = (sc[0] * c[2],) * 2
                sides.append((sc, js, fs, c2 >= 0))
            lo, up = sides
            scale = []
            for i0 in (0, 1):
                if lo and up:
                    x = torch.where(trop, lo[0][i0], up[0][i0])
                elif lo:
                    x = torch.where(trop, lo[0][i0], 0.0)
                else:
                    x = torch.where(trop, 0.0, up[0][i0])
                if not lw and p[8]:
                    x = torch.where(trop, x * c[3], x)
                scale.append(scaled(x) if lw else x)
            base = (((jp0 * 5 + jt0) * nspa, ((jp0 + 1) * 5 + jt10) * nspa),
                    (((jp - 13) * 5 + jt0) * nspb,
                     ((jp - 12) * 5 + jt10) * nspb))
            nsp = (nspa, nspb)
            tt = t
            for i0 in (0, 1):
                for off in (0, 1):
                    for e in (0, 1):
                        if e and nspa != 9 and nspb != 5:
                            continue
                        terms = []
                        for s, side in enumerate(sides):
                            if side is None:
                                terms.append(None)
                                continue
                            _, js, fs, has_eta = side
                            terms.append((
                                base[s][i0] + js[i0] + (off * nsp[s] + (
                                    e if has_eta or not lw else 0)),
                                fac[i0][off] * (fs[i0] if e
                                                else (1.0 - fs[i0]))))
                        if lo and up:
                            ix = torch.where(trop, terms[0][0],
                                             rows_a + terms[1][0])
                            wt = torch.where(trop, terms[0][1], terms[1][1])
                        elif lo:
                            ix = terms[0][0]
                            wt = torch.where(trop, terms[0][1], 0.0)
                        else:
                            ix = terms[1][0]
                            wt = torch.where(trop, 0.0, terms[1][1])
                        idx[tt], w[tt] = ix, wt * scale[i0]
                        tt += 1
        elif kind == 'lw_self':
            lin(I[p[0]], F[p[1]], scaled(torch.where(trop, F[p[2]], 0.0)))
        elif kind == 'lw_for':
            lin(I[p[0]], F[p[1]], scaled(times_mask(F[p[2]], p[3])))
        elif kind == 'lw_minor':
            col = F[p[3]]
            if p[2] == 0:
                amount = col * F[p[4]]
            else:
                # lw_spectral's adjn2o / adjco2: (thresh, base, expo)
                thresh, base, expo = c[:3]
                chi_ref = chi[p[7]][jp0 + 1]
                rat = col / (1.0e-20 * F[p[6]]) / chi_ref
                adj = (base + torch.clamp(rat - base, min=1e-30) ** expo) \
                    * chi_ref * F[p[6]] * 1.0e-20
                amount = torch.where(rat > thresh, adj, col)
            lin(I[p[0]], F[p[1]], scaled(masked(amount, p[5])))
        elif kind == 'lw_wx':
            w[t] = scaled(masked(F[p[0]], p[1]))
        elif kind == 'frac_row':
            w[t] = 1.0 if p[0] == NO_MASK else mask_f[p[0]]
        elif kind == 'frac_lin':
            js, fs = _eta(F[p[0]] / (F[p[0]] + c[0] * F[p[1]]), p[2])
            lin(js, fs, None if p[3] == NO_MASK else mask_f[p[3]])
        elif kind == 'sw_self':
            lin(I[p[0]], F[p[1]], torch.where(trop, F[p[2]], 0.0) * F[p[3]])
        elif kind == 'sw_for':
            lin(I[p[0]], F[p[1]], times_mask(F[p[2]] * F[p[3]], p[4]))
        elif kind == 'row_col':
            w[t] = times_mask(F[p[0]], p[1])
        elif kind == 'row_o2':
            w[t] = 4.35e-4 * F[p[0]] / 700.0
        elif kind == 'lin_eta':
            js, fs = _eta(F[p[0]] / (F[p[0]] + c[0] * F[p[1]]), p[4])
            lin(js, fs, times_mask(F[p[2]], p[3]))
        elif kind == 'sol_layer':
            # the band's reference layer in each column: the crossing of jp
            # and layreffr below the tropopause (else the layer above the
            # last tropospheric one) or above it (else the top)
            layreffr = p[1]
            if p[0] == 0:
                ltrop = torch.clamp(trop.sum(0) - 1, min=0)
                cross = trop & (jp < layreffr) & (
                    torch.roll(jp, -1, 0) >= layreffr)
                cross[-1] = False
                lay = torch.minimum(_last(cross, ltrop) + 1, ltrop)
            else:
                cross = ~trop & (jp >= layreffr) & (
                    torch.roll(jp, 1, 0) < layreffr)
                cross[0] = False
                lay = _last(cross, nz - 1)
            if p[2]:
                x1 = torch.gather(F[p[3]], 0, lay[None])[0]
                x2 = torch.gather(F[p[4]], 0, lay[None])[0]
                js_sol, fs_sol = _eta(x1 / (x1 + c[0] * x2), p[5])
        elif kind == 'sol_row':
            w[t] = float(factors[p[0]])
        elif kind == 'sol_lin':
            lin(js_sol, fs_sol, float(factors[p[0]]))
        else:
            raise ValueError('term plan: unknown entry kind %d' % rec[0])
    return groups


def taumol_terms(plan, groups, fields, chi=None, factors=()):
    """Write the terms of ``plan`` into ``groups``, as ``taumol_terms_cuda``
    does: the term-writer kernel for fields on a CUDA device, its plain
    version ``taumol_terms_plain`` for any other."""
    if fields['trop'].is_cuda:
        return taumol_terms_cuda(plan, groups, fields, chi, factors)
    return taumol_terms_plain(plan, groups, fields, chi, factors)
