"""RRTMG-LW 140-g-point correlated-k radiative transfer in PyTorch
(climt_tpu/components/rrtmg/lw_spectral.py).

The whole pipeline inatm -> setcoef -> taumol -> cldprop -> rtrn, in any
float type: the Pade-table transmittance (``use_tables=True``, the
default, as in JAX) or the analytic one, band clouds for every
inflag/iceflag/liqflag of ``cldprop_lw``, McICA per-g-point clouds
(``cldprmc_lw``, ``per_g_cloud``) and dF_up/dT_s (``idrv``).  Every table
interpolation of taumol (and setcoef's Planck functions) is a term of a
kernel-B group (``fused_mix.Group``): a direct gather over the merged
[absa; absb] table, the JAX package's f64 path, with one launch for all
bands of taug and one for the Planck fractions.  Both groups' terms come
from one walk of the band table (``lw_term_plan``), which one launch of
the term-writer kernel (``term_writer``) evaluates on the card and its
plain version on the CPU.  The flux integration goes through kernel A
(``rtrn_kernel.rtrn_lw_fused``) exactly where the JAX package takes its
Pallas kernel (lw_spectral.py:772-773): float32, analytic transmittance,
no idrv, band clouds; every other configuration runs the general sweep
here in plain PyTorch, as JAX runs it in XLA.

Layout as in the JAX module: layers bottom-up, columns trailing, g-points
innermost, taug (nz, ncol, 140).  The gas k-tables are chosen as the JAX
module chooses them (``load_kdist``): tables installed with
``load_aer_tables``, then an npz named by $CLIMT_TPU_LW_KTABLES, then the
real AER tables dropped in as ``climt_tpu/data/rrtmg_lw_kdist_aer.npz``,
then the calibrated surrogate (docs/RRTMG_LW_STATUS.md).  An install
takes effect at the next call: kernel B's packed layout is keyed by the
tables it packed (``fused_mix.Group``).  Tables passed as tensors that
require grad (``lw_surrogate.build_tables`` of a parameter vector) carry
the gradient through taumol: the LW k-table calibration
(``climt_tpu_torch.tools.calibrate_lw_ktables``) runs on it.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ... import data
from ...utils.profiling import phase
from . import fused_mix, term_writer
from .rtrn_kernel import (NBANDS, NG, NGB, NGPT, NGS, lw_sweeps,
                          rtrn_lw_fused)

ONEMINUS = 1.0 - 1.0e-6
AMD, AMW = 28.9660, 18.0160      # molecular weights (g/mol), inatm

# Pade transmittance lookup, copied from lw_spectral.py:69-81
NTBL, PADE, EXPEPS = 10000, 0.278, 1.0e-20
BPADE = 1.0 / PADE
_t = np.arange(1, NTBL) / NTBL
TAU_TBL = np.concatenate([[0.0], BPADE * _t / (1.0 - _t), [1.0e10]])
EXP_TBL = np.concatenate(
    [[1.0], np.maximum(np.exp(-TAU_TBL[1:-1]), EXPEPS), [EXPEPS]])
with np.errstate(divide='ignore', invalid='ignore'):
    _tfn = 1.0 - 2.0 * (1.0 / TAU_TBL[1:-1]
                        - EXP_TBL[1:-1] / (1.0 - EXP_TBL[1:-1]))
TFN_TBL = np.concatenate(
    [[0.0], np.where(TAU_TBL[1:-1] < 0.06, TAU_TBL[1:-1] / 6.0, _tfn),
     [1.0]])

# Cloud band mapping icb for ncbands 1/5/16 (lw_spectral.py:85-87)
ICB = np.array([[1] * 16,
                [1, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5],
                list(range(1, 17))]) - 1

# Band definitions, copied from lw_spectral.py:99 (BANDS_LW); keys as
# documented there.
BANDS_LW = [
    dict(num=1, lo=('h2o',), up=('h2o',), self_lo=True, for_lo=True,
         for_up=True, minors_lo=[('n2', 'n2')], minors_up=[('n2', 'n2')],
         corradj='b1'),
    dict(num=2, lo=('h2o',), up=('h2o',), self_lo=True, for_lo=True,
         for_up=True, corradj='b2'),
    dict(num=3, lo=('h2o', 'co2', 'h2oco2'), up=('h2o', 'co2', 'h2oco2'),
         self_lo=True, for_lo=True, for_up=True,
         planck_lo=('h2o', 'co2', (1, 2, 9)),
         planck_up=('h2o', 'co2', (1, 2, 13)),
         minors_lo=[('n2o', 'adjn2o')], minors_up=[('n2o', 'adjn2o')]),
    dict(num=4, lo=('h2o', 'co2', 'h2oco2'), up=('o3', 'co2', 'o3co2'),
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('h2o', 'co2', (1, 2, 11)),
         planck_up=('o3', 'co2', (3, 2, 13))),
    dict(num=5, lo=('h2o', 'co2', 'h2oco2'), up=('o3', 'co2', 'o3co2'),
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('h2o', 'co2', (1, 2, 5)),
         planck_up=('o3', 'co2', (3, 2, 43)),
         minors_lo=[('o3', 'plain')], wx_lo=[('ccl4', 'ccl4')],
         wx_up=[('ccl4', 'ccl4')]),
    dict(num=6, lo=('h2o',), up=None, self_lo=True, for_lo=True,
         for_up=False,
         minors_lo=[('co2', ('adjco2', 2.0, 2.0, 0.77))],
         wx_lo=[('cfc11', 'cfc11adj'), ('cfc12', 'cfc12')],
         wx_up=[('cfc11', 'cfc11adj'), ('cfc12', 'cfc12')]),
    dict(num=7, lo=('h2o', 'o3', 'h2oo3'), up=('o3',),
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('h2o', 'o3', (1, 3, 3)),
         minors_lo=[('co2', ('adjco2', 3.0, 2.0, 0.79))],
         minors_up=[('co2', ('adjco2', 3.0, 2.0, 0.79))]),
    dict(num=8, lo=('h2o',), up=('o3',), self_lo=True, for_lo=True,
         for_up=False,
         minors_lo=[('co2', ('adjco2', 3.0, 2.0, 0.65)),
                    ('o3', 'plain'), ('n2o', 'plain')],
         minors_up=[('co2', ('adjco2', 3.0, 2.0, 0.65)),
                    ('n2o', 'plain')],
         wx_lo=[('cfc12', 'cfc12'), ('cfc22', 'cfc22adj')],
         wx_up=[('cfc12', 'cfc12'), ('cfc22', 'cfc22adj')]),
    dict(num=9, lo=('h2o', 'ch4', 'h2och4'), up=('ch4',),
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('h2o', 'ch4', (1, 6, 9)),
         minors_lo=[('n2o', 'adjn2o')], minors_up=[('n2o', 'adjn2o')]),
    dict(num=10, lo=('h2o',), up=('h2o',), self_lo=True, for_lo=True,
         for_up=True),
    dict(num=11, lo=('h2o',), up=('h2o',), self_lo=True, for_lo=True,
         for_up=True,
         minors_lo=[('o2', 'plain')], minors_up=[('o2', 'plain')]),
    dict(num=12, lo=('h2o', 'co2', 'h2oco2'), up=None,
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('h2o', 'co2', (1, 2, 10))),
    dict(num=13, lo=('h2o', 'n2o', 'h2on2o'), up=None,
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('h2o', 'n2o', (1, 4, 5)),
         minors_lo=[('co2', ('adjco2', 3.0, 2.0, 0.68)), ('co', 'plain')],
         minors_up=[('o3', 'plain')]),
    dict(num=14, lo=('co2',), up=('co2',), self_lo=True, for_lo=True,
         for_up=False),
    dict(num=15, lo=('n2o', 'co2', 'n2oco2'), up=None,
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('n2o', 'co2', (4, 2, 1)),
         minors_lo=[('n2', 'n2')]),
    dict(num=16, lo=('h2o', 'ch4', 'h2och4'), up=('ch4',),
         self_lo=True, for_lo=True, for_up=False,
         planck_lo=('h2o', 'ch4', (1, 6, 6))),
]

# chi_mls row (1-based) per species and the key-species ratio pairs
# (lw_spectral.py:167-171)
CHI_ROW = dict(h2o=1, co2=2, o3=3, n2o=4, co=5, ch4=6, o2=7)
RAT_PAIRS = dict(h2oco2=('h2o', 'co2'), o3co2=('o3', 'co2'),
                 h2oo3=('h2o', 'o3'), h2och4=('h2o', 'ch4'),
                 h2on2o=('h2o', 'n2o'), n2oco2=('n2o', 'co2'))


def load_support():
    """rrtmg_lw_support.npz as a dict of numpy arrays (:179)."""
    return data.load_npz(data.LW_SUPPORT)


def support_tensors(dtype, device):
    """rrtmg_lw_support.npz as tensors of ``dtype`` on ``device``
    (cached)."""
    return data.load_tensors(data.LW_SUPPORT, dtype, device)


_KDIST_OVERRIDE = [None]     # set by load_aer_tables (lw_spectral.py:175)


def load_kdist():
    """Gas k-distribution tables, a dict of numpy arrays (:183).

    Preference order: (1) tables installed via ``load_aer_tables``,
    (2) the npz named by $CLIMT_TPU_LW_KTABLES, (3) the real AER tables
    dropped in as ``data.LW_KDIST_AER``, (4) the calibrated surrogate.  As
    in JAX, the choice is kept in ``_KDIST_OVERRIDE`` until the next
    install (or until the override is set back to None).  A variable that
    names no file raises, where JAX goes on to the next choice."""
    if _KDIST_OVERRIDE[0] is not None:
        return _KDIST_OVERRIDE[0]
    env = os.environ.get('CLIMT_TPU_LW_KTABLES')
    drop_in = os.path.join(data.DATA_DIR, data.LW_KDIST_AER)
    if env:
        _KDIST_OVERRIDE[0] = data.load_npz(env)
    elif os.path.exists(drop_in):
        _KDIST_OVERRIDE[0] = data.load_npz(drop_in)
    else:
        _KDIST_OVERRIDE[0] = data.load_numpy(data.LW_KDIST)
    return _KDIST_OVERRIDE[0]


def load_aer_tables(path):
    """Install real AER RRTMG-LW k-tables for all subsequent calls (:202)
    and return them.

    ``path`` is an npz whose keys follow the surrogate layout
    (tools/build_lw_surrogate_ktables.py): per band ``b{n}_absa`` /
    ``b{n}_absb`` with rows flattened as (jp*5 + jt)*nspa + js (the
    Fortran ka/kb index order of rrtmg_lw_k_g.f90, g-points last),
    ``b{n}_selfref`` (10, ng), ``b{n}_forref`` (4, ng),
    ``b{n}_fracrefa``/``fracrefb`` ((ng,) or (ng, neta)),
    ``b{n}_k{a|b}_m{gas}`` minor-gas tables (19, ng), and the
    ``ccl4/cfc11adj/cfc12/cfc22adj`` cross-sections (ng,).  The file is
    read afresh on every install; a missing or malformed file raises."""
    _KDIST_OVERRIDE[0] = data.load_npz(path)
    return _KDIST_OVERRIDE[0]


def _support_scalar(name):
    return float(data.load_numpy(data.LW_SUPPORT)[name].reshape(-1)[0])


def _trunc_int(x):
    """Truncate toward zero, then cast (lw_spectral.py:220): selects rows.
    int32, the index type kernel B reads."""
    return torch.trunc(x).to(torch.int32)


def inatm_lw(play, plev, tlay, vmr, grav, avogad):
    """Column amounts (molec/cm^2) and precipitable water (:224)."""
    h2o = vmr['h2o']
    amm = (1.0 - h2o) * AMD + h2o * AMW
    dp = plev[:-1] - plev[1:]
    coldry = dp * 1.0e3 * avogad / (1.0e2 * grav * amm * (1.0 + h2o))
    wkl = {gas: coldry * vmr[gas] for gas in vmr}
    summol = sum(vmr[g] for g in ('co2', 'o3', 'n2o', 'co', 'ch4', 'o2'))
    wbroad = coldry * (1.0 - summol)
    amttl = torch.sum(coldry + wkl['h2o'], dim=0)
    wvttl = torch.sum(wkl['h2o'], dim=0)
    wvsh = (AMW * wvttl) / (AMD * amttl)
    pwvcm = wvsh * (1.0e3 * plev[0]) / (1.0e2 * grav)
    return coldry, wkl, wbroad, pwvcm


def planck_terms(tavel, tz, tbound):
    """The Planck functions of the layers, levels and surface (setcoef
    :246) as one kernel-B group over their temperatures, unlaunched:
    (nz*ncol + (nz+1)*ncol + ncol, 16) once run."""
    temp = torch.cat([tavel.reshape(-1), tz.reshape(-1), tbound.reshape(-1)])
    ind = torch.clamp(_trunc_int(temp - 159.0), 1, 180)
    group = fused_mix.Group('lw_planck', temp.shape, temp.dtype, temp.device)
    group.band(16)
    group.part(data.load_numpy(data.LW_SUPPORT)['totplnk'])
    group.lin(ind - 1, temp - 159.0 - ind)
    return group


def setcoef_lw(pavel, tavel, tz, tbound, semiss, coldry, wkl, wbroad,
               idrv=False):
    """Interpolation indices/factors and Planck values (:246); with idrv
    also the surface Planck derivative ``dplankbnd_dt`` (:342-346)."""
    t = support_tensors(pavel.dtype, pavel.device)
    preflog, tref, chi = t['preflog'], t['tref'], t['chi_mls']
    stpfac = 296.0 / 1013.0

    plog = torch.log(pavel)
    jp = torch.clamp(_trunc_int(36.0 - 5.0 * (plog + 0.04)), 1, 58)
    jp0 = jp - 1
    fp = 5.0 * (preflog[jp0] - plog)

    def t_index(jpx):
        jt = torch.clamp(_trunc_int(3.0 + (tavel - tref[jpx]) / 15.0), 1, 4)
        ft = (tavel - tref[jpx]) / 15.0 - (jt - 3)
        return jt - 1, ft

    jt0, ft = t_index(jp0)
    jt10, ft1 = t_index(jp0 + 1)
    compfp = 1.0 - fp

    trop = plog > 4.56
    water = wkl['h2o'] / coldry
    scalefac = pavel * stpfac / tavel
    forfac_lo = scalefac / (1.0 + water)
    fac_lo = (332.0 - tavel) / 36.0
    indfor_lo = torch.clamp(_trunc_int(fac_lo), 1, 2)
    forfrac_lo = fac_lo - indfor_lo
    fac_up = (tavel - 188.0) / 36.0
    indfor = torch.where(trop, indfor_lo, 3) - 1
    forfrac = torch.where(trop, forfrac_lo, fac_up - 1.0)
    forfac = forfac_lo

    fac_s = (tavel - 188.0) / 7.2
    indself = torch.clamp(_trunc_int(fac_s) - 7, 1, 9) - 1
    selffrac = fac_s - (indself + 1 + 7)
    selffac = torch.where(trop, water * forfac, 0.0)
    selffrac = torch.where(trop, selffrac, 0.0)
    indself = torch.where(trop, indself, 0)

    scaleminor = pavel / tavel
    scaleminorn2 = scaleminor * (wbroad / (coldry + wkl['h2o']))
    fac_m = (tavel - 180.8) / 7.2
    indminor = torch.clamp(_trunc_int(fac_m), 1, 18) - 1
    minorfrac = fac_m - (indminor + 1)

    cols = {'col' + g: 1.0e-20 * wkl[g] for g in wkl}
    for g in ('co2', 'o3', 'n2o', 'ch4', 'o2', 'co'):
        c = cols['col' + g]
        cols['col' + g] = torch.where(c == 0.0, 1.0e-32 * coldry, c)
    cols['colbrd'] = 1.0e-20 * wbroad

    rats = {}
    for pair, (s1, s2) in RAT_PAIRS.items():
        r1, r2 = CHI_ROW[s1] - 1, CHI_ROW[s2] - 1
        rats['rat_' + pair] = chi[r1][jp0] / chi[r2][jp0]
        rats['rat_' + pair + '_1'] = chi[r1][jp0 + 1] / chi[r2][jp0 + 1]

    plnk = planck_terms(tavel, tz, tbound).run()
    nlay, nlev = tavel.numel(), tz.numel()
    planklay = plnk[:nlay].view(tavel.shape + (16,))
    planklev = plnk[nlay:nlay + nlev].view(tz.shape + (16,))
    plankbnd = semiss.T * plnk[nlay + nlev:]

    out = dict(
        trop=trop, jp=jp, jp0=jp0, jt0=jt0, jt10=jt10,
        fac00=compfp * (1.0 - ft), fac10=compfp * ft,
        fac01=fp * (1.0 - ft1), fac11=fp * ft1,
        selffac=selffac, selffrac=selffrac, indself=indself,
        forfac=forfac, forfrac=forfrac, indfor=indfor,
        scaleminor=scaleminor, scaleminorn2=scaleminorn2,
        indminor=indminor, minorfrac=minorfrac,
        coldry=coldry, chi=chi,
        planklay=planklay, planklev=planklev, plankbnd=plankbnd,
        **cols, **rats)
    if idrv:
        ind = torch.clamp(_trunc_int(tbound - 159.0), 1, 180)
        frac = tbound - 159.0 - ind
        lo, hi = t['totplnkderiv'][ind - 1], t['totplnkderiv'][ind]
        out['dplankbnd_dt'] = semiss.T * (lo + frac[..., None] * (hi - lo))
    return out


def _stack_rows(*tables):
    """Tables joined row-wise: numpy with numpy, and with ``torch.cat``
    (which autograd follows) when any of them is a tensor."""
    if not any(torch.is_tensor(t) for t in tables):
        return np.concatenate(tables, axis=0)
    ref = next(t for t in tables if torch.is_tensor(t))
    return torch.cat([torch.as_tensor(t, dtype=ref.dtype, device=ref.device)
                      for t in tables])


def taumol_lw_terms(cs, wx, dtype, tables=None):
    """The terms of taumol (:396) as two kernel-B groups, unlaunched:
    taug and the Planck fractions, each (nz, ncol, 140) once run, from
    ``tables`` (a dict in ``load_aer_tables``' layout of numpy arrays or
    of tensors, which may require grad: the groups' outputs then carry
    the gradient back to them; None: ``load_kdist()``).  Every band's
    key-species 2x2x2 interpolation (one part, the merged [absa; absb]
    table), continua, minor gases and cross-sections are terms of one band
    of the taug group; the band-1/2 pressure corrections are folded into
    their weights, as are the trop/upper masks of the Planck fractions.
    ``term_writer.taumol_terms`` writes them from ``lw_term_plan``."""
    trop = cs['trop']
    nz, ncol = trop.shape
    t = load_kdist() if tables is None else tables
    names = tuple(sorted(wx))
    plan = term_writer.cached_plan(('lw', names), t, dtype, trop.device,
                                   lambda: lw_term_plan(t, names))
    groups = (fused_mix.Group(('lw_taug', names), (nz, ncol), dtype,
                              trop.device, source=t),
              fused_mix.Group('lw_fracs', (nz, ncol), dtype, trop.device,
                              source=t))
    fields = dict(cs)
    fields.update(('wx_' + gas, x) for gas, x in wx.items())
    return term_writer.taumol_terms(plan, groups, fields, cs['chi'])


def lw_term_plan(t, wx_names):
    """The term plan of ``taumol_lw_terms`` for the tables ``t`` and the
    cross-section gases ``wx_names``: the walk over ``BANDS_LW`` that
    records each band's terms as entries (``term_writer.TermPlan``),
    group 0 taug, group 1 the Planck fractions."""
    taug, fracs = 0, 1
    sup = data.load_numpy(data.LW_SUPPORT)
    plan = term_writer.TermPlan(2)
    f, i = plan.field, plan.int_field

    def spec(s):
        """Field ids of a key-species tuple: column 1, column 2, and the
        ratios at jp and jp+1 (-1 where absent)."""
        if s is None:
            return [-1] * 4
        if len(s) == 1:
            return [f('col' + s[0])] + [-1] * 3
        return [f('col' + s[0]), f('col' + s[1]), f('rat_' + s[2]),
                f('rat_' + s[2] + '_1')]

    for bi, bd in enumerate(BANDS_LW):
        num, ng = bd['num'], NG[bi]

        def tab(name, b=num):
            return t.get('b%d_%s' % (b, name))

        plan.band(taug, ng)
        plan.entry('lw_band', taug, [{'b1': 1, 'b2': 2}.get(
            bd.get('corradj'), 0), f('pavel')])
        absa, absb = tab('absa'), tab('absb')
        have_lo = bd['lo'] is not None
        have_up = bd['up'] is not None
        nspa = 9 if (have_lo and len(bd['lo']) == 3) else (
            1 if have_lo else 0)
        nspb = 5 if (have_up and len(bd['up']) == 3) else (
            1 if have_up else 0)
        if have_lo or have_up:
            rows_a = 0
            if have_lo and have_up:
                plan.part(taug, _stack_rows(absa, absb))
                rows_a = absa.shape[0]
            else:
                plan.part(taug, absa if have_lo else absb)
            plan.entry('lw_key', taug, [nspa, nspb, rows_a] + spec(bd['lo'])
                       + spec(bd['up']),
                       nterms=8 if (nspa == 9 or nspb == 5) else 4)

        selfref, forref = tab('selfref'), tab('forref')
        if bd.get('self_lo') and selfref is not None:
            plan.part(taug, selfref)
            plan.entry('lw_self', taug, [i('indself'), f('selffrac'),
                                         f('selffac')], nterms=2)
        if (bd.get('for_lo') or bd.get('for_up')) and forref is not None:
            mask = (term_writer.NO_MASK if bd.get('for_lo') and bd.get(
                'for_up') else term_writer.TROP if bd.get('for_lo')
                else term_writer.UPPER)
            plan.part(taug, forref)
            plan.entry('lw_for', taug, [i('indfor'), f('forfrac'),
                                        f('forfac'), mask], nterms=2)

        for region, key in (('lo', 'minors_lo'), ('up', 'minors_up')):
            mask = term_writer.TROP if region == 'lo' else term_writer.UPPER
            for gas, mode in bd.get(key, ()):
                ktab = tab('k%s_m%s' % ('a' if region == 'lo' else 'b', gas))
                if ktab is None:
                    continue
                plan.part(taug, ktab)
                if mode in ('n2', 'plain'):
                    amount = [0, f('colbrd' if mode == 'n2' else 'col' + gas),
                              f('scaleminorn2' if mode == 'n2'
                                else 'scaleminor'), mask, -1, -1]
                    consts = ()
                else:
                    adj = ('n2o', 1.5, 0.5, 0.65) if mode == 'adjn2o' else (
                        'co2',) + tuple(mode[1:])
                    amount = [1, f('col' + gas), -1, mask, f('coldry'),
                              CHI_ROW[adj[0]] - 1]
                    consts = adj[1:]
                plan.entry('lw_minor', taug, [i('indminor'), f('minorfrac')]
                           + amount, consts, nterms=2)

        for region, key in (('lo', 'wx_lo'), ('up', 'wx_up')):
            for gas, tname in bd.get(key, ()):
                xs = tab(tname)
                if xs is None or gas not in wx_names:
                    continue
                plan.part(taug, xs)
                plan.entry('lw_wx', taug, [f('wx_' + gas), (
                    term_writer.TROP if region == 'lo'
                    else term_writer.UPPER)], nterms=1)

        plan.band(fracs, ng)
        fraca, fracb = tab('fracrefa'), tab('fracrefb')
        for frtab, planck_spec, n_eta, mask in (
                (fraca, bd.get('planck_lo'), 8, term_writer.TROP
                 if fracb is not None else term_writer.NO_MASK),
                (fracb, bd.get('planck_up'), 4, term_writer.UPPER)):
            if frtab is None:
                continue
            if frtab.ndim == 1:
                plan.part(fracs, frtab)
                plan.entry('frac_row', fracs, [mask], nterms=1)
                continue
            s1, s2, (r1, r2, lev) = planck_spec
            refrat = float(sup['chi_mls'][r1 - 1, lev - 1]
                           / sup['chi_mls'][r2 - 1, lev - 1])
            plan.part(fracs, frtab.T)
            plan.entry('frac_lin', fracs, [f('col' + s1), f('col' + s2),
                                           n_eta, mask], [refrat], nterms=2)
    return plan


def taumol_lw(cs, wx, dtype, tables=None):
    """Gaseous optical depth and Planck fractions per g-point (:396) from
    ``tables`` (None: ``load_kdist()``).

    Returns taug, fracs: (nz, ncol, 140), one kernel-B launch each."""
    taug_g, fracs_g = taumol_lw_terms(cs, wx, dtype, tables)
    return taug_g.run(), fracs_g.run()


def _cloud_abs_coeffs(iceflag, liqflag, ciwp, clwp, rei, rel, dtype=None):
    """Per-band ice/liquid mass absorption coefficients, mapped through
    the icb pattern onto the 16 bands: (nz, ncol, 16) each (:615), from
    the tables in ``dtype`` (None: the inputs' dtype)."""
    t = support_tensors(dtype or ciwp.dtype, ciwp.device)
    shape = tuple(ciwp.shape) + (16,)
    rei_safe = torch.clamp(rei, min=1.0e-20)
    if iceflag == 0:
        a = t['absice0']
        absice = (a[0] + a[1] / rei_safe)[..., None].expand(shape)
        ice_ncb = 1
    elif iceflag == 1:
        a = t['absice1']                             # (2, 5)
        absice = a[0] + a[1] / rei_safe[..., None]   # (nz, ncol, 5)
        ice_ncb = 5
    else:
        table = t['absice2' if iceflag == 2 else 'absice3']   # (43|46, 16)
        nidx = table.shape[0]
        factor = (rei - 2.0) / 3.0
        index = torch.clamp(_trunc_int(factor), 1, nidx - 1)
        fint = factor - index
        lo = table[index - 1]
        hi = table[torch.clamp(index, 0, nidx - 1)]
        absice = lo + fint[..., None] * (hi - lo)
        ice_ncb = 16
    absice = torch.where((ciwp > 0.0)[..., None], absice, 0.0)

    if liqflag == 0:
        absliq = t['absliq0'].reshape(1).expand(tuple(ciwp.shape) + (1,))
        liq_ncb = 1
    else:
        table = t['absliq1']                         # (58, 16)
        index = torch.clamp(_trunc_int(rel - 1.5), 1, 57)
        fint = rel - 1.5 - index
        lo = table[index - 1]
        hi = table[index]
        absliq = lo + fint[..., None] * (hi - lo)
        liq_ncb = 16
    absliq = torch.where((clwp > 0.0)[..., None], absliq, 0.0)

    dev = ciwp.device
    ice_ind = {1: 0, 5: 1, 16: 2}[ice_ncb]
    liq_ind = {1: 0, 16: 2}[liq_ncb]
    absice16 = absice[..., torch.as_tensor(ICB[ice_ind], device=dev)]
    absliq16 = absliq[..., torch.as_tensor(ICB[liq_ind], device=dev)]
    return absice16, absliq16


def _cloudy_mask(cldfrac, ciwp, clwp, tauc):
    cldmin = 1.0e-6
    cwp = ciwp + clwp
    tauctot = torch.sum(tauc, dim=-1)
    return (cldfrac >= cldmin) & ((cwp >= cldmin) | (tauctot >= cldmin))


def cldprop_lw(inflag, iceflag, liqflag, cldfrac, tauc, ciwp, clwp,
               rei, rel, dtype=None):
    """Cloud optical depth per LW band, (nz, ncol, 16), already mapped
    through the icb pattern (:672): direct input (inflag 0), one cloud
    type (1), or ice and liquid with iceflag 0-3 and liqflag 0-1 (2).
    ``dtype`` is that of the absorption tables, which the result is
    promoted with as in JAX; None takes the inputs' dtype."""
    cloudy = _cloudy_mask(cldfrac, ciwp, clwp, tauc)[..., None]
    if inflag == 0:
        return torch.where(cloudy, tauc, 0.0)
    if inflag == 1:
        abscld1 = _support_scalar('abscld1')
        tau = (abscld1 * (ciwp + clwp))[..., None].expand(
            tuple(ciwp.shape) + (16,))
        if dtype is not None:
            tau = tau.to(torch.promote_types(tau.dtype, dtype))
        return torch.where(cloudy, tau, 0.0)
    absice16, absliq16 = _cloud_abs_coeffs(iceflag, liqflag, ciwp, clwp,
                                           rei, rel, dtype)
    tau = ciwp[..., None] * absice16 + clwp[..., None] * absliq16
    return torch.where(cloudy, tau, 0.0)


def cldprmc_lw(inflag, iceflag, liqflag, cldfmc, ciwpmc, clwpmc, taucmc,
               rei, rel, dtype=None):
    """Per-g-point McICA cloud optical depth, (nz, ncol, 140) (:693): the
    optics of cldprop applied to each subcolumn, ``dtype`` as there."""
    if inflag == 0:
        return taucmc
    if inflag == 1:
        return _support_scalar('abscld1') * (ciwpmc + clwpmc)
    ngb = torch.as_tensor(NGB, dtype=torch.int64, device=ciwpmc.device)
    # the coefficients' masks see "any subcolumn has water"
    absice16, absliq16 = _cloud_abs_coeffs(
        iceflag, liqflag, torch.amax(ciwpmc, -1), torch.amax(clwpmc, -1),
        rei, rel, dtype)
    return ciwpmc * absice16[..., ngb] + clwpmc * absliq16[..., ngb]


@functools.lru_cache()
def _pade_tables(dtype, device):
    return tuple(torch.as_tensor(x, dtype=dtype, device=device)
                 for x in (TAU_TBL, EXP_TBL, TFN_TBL))


def _tbl_index(od):
    """Row of the Pade tables for optical depth ``od`` (:724-725), with
    JAX's gather semantics for rows outside the table (a negative
    optical depth): a negative row counts from the end, then the row is
    clamped to the table."""
    i = _trunc_int(NTBL * (od / (BPADE + od)) + 0.5).long()
    return torch.clamp(torch.where(i < 0, i + (NTBL + 1), i), 0, NTBL)


def _tbl_lookup(od, use_tables=True):
    """(quantized od, absorptance 1 - exp(-od), source factor tfn) through
    the Pade lookup tables, or analytically with use_tables=False
    (:712)."""
    if not use_tables:
        od_safe = torch.clamp(od, min=1.0e-12)
        expo = torch.exp(-od_safe)
        tfn = torch.where(
            od_safe < 0.06, od_safe / 6.0,
            1.0 - 2.0 * (1.0 / od_safe - expo / (1.0 - expo)))
        return od, 1.0 - expo, tfn
    itr = _tbl_index(od)
    tau_tbl, exp_tbl, tfn_tbl = _pade_tables(od.dtype, od.device)
    return tau_tbl[itr], 1.0 - exp_tbl[itr], tfn_tbl[itr]


def _secdiff(pwvcm, t):
    """Diffusivity secant per band and column, (16, ncol)
    (rtrn.f90:260-268)."""
    fixed = np.zeros(16, bool)
    fixed[[0, 3]] = True
    fixed[9:] = True
    sec = (t['secdiff_a0'][:, None] + t['secdiff_a1'][:, None]
           * torch.exp(t['secdiff_a2'][:, None] * pwvcm[None]))
    sec = torch.clamp(sec, 1.5, 1.8)
    return torch.where(torch.as_tensor(fixed, device=pwvcm.device)[:, None],
                       1.66, sec)


def rtrn_lw(taug, fracs, planklay, planklev, plankbnd, semiss, pwvcm,
            cldfrac, taucld_band, pz, heatfac, idrv=False,
            dplankbnd_dt=None, per_g_cloud=False, use_tables=True):
    """Random-overlap radiative transfer (:732).  taucld_band (nz, ncol,
    16) band cloud optical depth, or with per_g_cloud (nz, ncol, 140)
    McICA subcolumns whose cldfrac is per g-point 0/1.

    Returns (totuflux, totdflux, htr, totuclfl, totdclfl, htrc) and, with
    idrv, (duflx_dt, duflxc_dt): fluxes (nz+1, ncol), heating (nz, ncol).
    Kernel A takes exactly the configurations the JAX package gives its
    Pallas kernel (:772-773): float32, analytic, no idrv, band clouds."""
    dtype, device = taug.dtype, taug.device
    t = support_tensors(dtype, device)
    ngb = torch.as_tensor(NGB, dtype=torch.int64, device=device)
    secdiff = _secdiff(pwvcm, t)                     # (16, ncol)
    rec_6 = _support_scalar('rec_6')
    fluxfac = np.pi * 2.0e4
    dwave_g = t['delwave'][ngb] * _support_scalar('wtdiff') * fluxfac

    if (dtype == torch.float32 and not use_tables and not idrv
            and not per_g_cloud):
        fluxes = rtrn_lw_fused(
            taug, fracs, planklay, planklev, plankbnd, semiss, secdiff,
            cldfrac, taucld_band, dwave_g, rec_6)
    else:
        fluxes = _rtrn_lw_general(
            taug, fracs, planklay, planklev, plankbnd, semiss, secdiff,
            cldfrac, taucld_band, dwave_g, rec_6, dplankbnd_dt if idrv
            else None, per_g_cloud, use_tables)
    totuflux, totdflux, totuclfl, totdclfl = fluxes[:4]
    fnet = totuflux - totdflux
    fnetc = totuclfl - totdclfl
    dpz = pz[:-1] - pz[1:]
    htr = heatfac * (fnet[:-1] - fnet[1:]) / dpz
    htrc = heatfac * (fnetc[:-1] - fnetc[1:]) / dpz
    return (totuflux, totdflux, htr, totuclfl, totdclfl, htrc) + fluxes[4:]


def _rtrn_lw_general(taug, fracs, planklay, planklev, plankbnd, semiss,
                     secdiff, cldfrac, taucld, dwave_g, rec_6, dplankbnd_dt,
                     per_g_cloud, use_tables):
    """The XLA path of rtrn_lw (:787-940) with Python loops over z, in any
    dtype: Pade tables or analytic transmittance, band or per-g clouds,
    and the dF_up/dT_s sweep when ``dplankbnd_dt`` is given.  Returns
    (totuflux, totdflux, totuclfl, totdclfl[, duflx_dt, duflxc_dt])."""
    ngb = torch.as_tensor(NGB, dtype=torch.int64, device=taug.device)
    sec_g = secdiff.T[:, ngb]                          # (ncol, 140)
    odepth = torch.clamp(sec_g * taug, min=0.0)        # (nz, ncol, 140)
    blay = planklay[..., ngb]
    bup = planklev[1:][..., ngb] - blay
    bdn = planklev[:-1][..., ngb] - blay
    if per_g_cloud:
        odcld = sec_g * taucld
        cldf = cldfrac
    else:
        odcld = (taucld * secdiff.T)[..., ngb]
        cldf = cldfrac[..., None].expand_as(odcld)
    cloudy = cldf >= 1.0e-6
    odcld = torch.where(cloudy, odcld, 0.0)

    # gas-only quantities with the od < 0.06 quadratic/table split
    odt, a_tbl, tfn_tbl = _tbl_lookup(odepth, use_tables)
    small = odepth <= 0.06
    atrans = torch.where(small, odepth - 0.5 * odepth * odepth, a_tbl)
    tfacgas = torch.where(small, rec_6 * odepth, tfn_tbl)
    odtot = torch.where(small, odepth, odt) + odcld
    _, atot_tbl, tfactot_tbl = _tbl_lookup(odtot, use_tables)
    small_tot = odtot < 0.06
    atot = torch.where(small_tot, odtot - 0.5 * odtot * odtot, atot_tbl)
    tfactot = torch.where(small_tot, rec_6 * odtot, tfactot_tbl)

    efclfrac = torch.where(cloudy, (1.0 - torch.exp(-odcld)) * cldf, 0.0)
    rad0 = fracs[0] * plankbnd[:, ngb]
    urad, drad, curad, cdrad = lw_sweeps(
        atrans, atot, fracs * (blay + tfacgas * bdn),
        fracs * (blay + tfacgas * bup), fracs * (blay + tfactot * bdn),
        fracs * (blay + tfactot * bup), efclfrac, cldf, cloudy, rad0,
        1.0 - semiss.T[:, ngb])

    def to_flux(levels):
        return torch.einsum('lcg,g->lc', torch.stack(levels), dwave_g)

    out = (to_flux(urad), to_flux(drad), to_flux(curad), to_flux(cdrad))
    if dplankbnd_dt is None:
        return out
    # dF_up/dT_s: the surface term transmitted up through each layer
    d_rad0 = fracs[0] * dplankbnd_dt[:, ngb]
    trans_clear = 1.0 - atrans
    trans_layer = torch.where(
        cloudy, (1.0 - atot) * cldf + trans_clear * (1.0 - cldf),
        trans_clear)
    d_lu, d_clru = [d_rad0], [d_rad0]
    for z in range(taug.shape[0]):
        d_lu.append(d_lu[-1] * trans_layer[z])
        d_clru.append(d_clru[-1] * trans_clear[z])
    return out + (to_flux(d_lu), to_flux(d_clru))


def gas_coefs_lw(play, plev, tlay, tlev, tsfc, emis, h2ovmr, o3vmr,
                 co2vmr, ch4vmr, n2ovmr, o2vmr, cfc11vmr, cfc12vmr,
                 cfc22vmr, ccl4vmr, grav, avogad, idrv=False):
    """inatm and setcoef of rrtmg_lw_fluxes (:977-989): the interpolation
    coefficients ``cs``, the cross-section amounts ``wx`` and the
    precipitable water ``pwvcm`` that taumol and rtrn read."""
    vmr = dict(h2o=h2ovmr, co2=co2vmr, o3=o3vmr, n2o=n2ovmr,
               co=torch.zeros_like(play), ch4=ch4vmr, o2=o2vmr)
    coldry, wkl, wbroad, pwvcm = inatm_lw(play, plev, tlay, vmr, grav,
                                          avogad)
    wx = {name: coldry * v * 1.0e-20
          for name, v in (('ccl4', ccl4vmr), ('cfc11', cfc11vmr),
                          ('cfc12', cfc12vmr), ('cfc22', cfc22vmr))}
    cs = setcoef_lw(play, tlay, tlev, tsfc, emis, coldry, wkl, wbroad,
                    idrv=idrv)
    cs['pavel'] = play
    return cs, wx, pwvcm


def rrtmg_lw_fluxes(play, plev, tlay, tlev, tsfc, h2ovmr, o3vmr, co2vmr,
                    ch4vmr, n2ovmr, o2vmr, cfc11vmr, cfc12vmr, cfc22vmr,
                    ccl4vmr, emis, cldfrac, taucld, ciwp, clwp, rei, rel,
                    tauaer, grav, avogad, cpdair, inflag=2, iceflag=1,
                    liqflag=1, idrv=False, per_g_cloud=False,
                    cldfrac_g=None, taucld_g=None, tables=None,
                    use_tables=True):
    """Full LW pipeline inatm -> setcoef -> taumol -> cldprop -> rtrn
    (:959), with the gas k-tables ``tables`` (None: ``load_kdist()``; a
    dict of tensors that require grad makes the outputs differentiable in
    them: on the card through kernel B's backward in float64, while a
    float32 call there stops at kernel A, which has none).  Profiles (nz, ncol) bottom-up, plev/tlev (nz+1, ncol), tsfc
    (ncol,), emis (16, ncol), taucld/tauaer (nz, ncol, 16).  With
    per_g_cloud, the McICA subcolumns cldfrac_g/taucld_g (nz, ncol, 140)
    replace cldfrac/taucld.

    Returns (uflx, dflx, hr, uflxc, dflxc, hrc[, duflx_dt, duflxc_dt]):
    fluxes (nz+1, ncol) W/m^2, heating rates (nz, ncol) K/day."""
    with phase('climt.gas_optics'):
        cs, wx, pwvcm = gas_coefs_lw(
            play, plev, tlay, tlev, tsfc, emis, h2ovmr, o3vmr, co2vmr,
            ch4vmr, n2ovmr, o2vmr, cfc11vmr, cfc12vmr, cfc22vmr, ccl4vmr,
            grav, avogad, idrv=idrv)
        taug, fracs = taumol_lw(cs, wx, play.dtype, tables)
    ngb = torch.as_tensor(NGB, dtype=torch.int64, device=play.device)
    taug = taug + tauaer[..., ngb]
    heatfac = grav * 8.64e4 / (cpdair * 1.0e2)
    if per_g_cloud:
        cldfrac, taucld_band = cldfrac_g, taucld_g
    else:
        taucld_band = cldprop_lw(inflag, iceflag, liqflag, cldfrac, taucld,
                                 ciwp, clwp, rei, rel)
    with phase('climt.lw_sweep'):
        return rtrn_lw(taug, fracs, cs['planklay'], cs['planklev'],
                       cs['plankbnd'], emis, pwvcm, cldfrac, taucld_band,
                       plev, heatfac, idrv=idrv,
                       dplankbnd_dt=cs.get('dplankbnd_dt'),
                       per_g_cloud=per_g_cloud, use_tables=use_tables)
