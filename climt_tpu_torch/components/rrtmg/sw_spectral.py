"""RRTMG-SW 112-g-point correlated-k radiative transfer in PyTorch
(climt_tpu/components/rrtmg/sw_spectral.py).

The whole driver in any float type: the Pade-table exponential
(``use_tables=True``, the default, as in JAX) or the analytic one, cloud
optics for every flag of ``cldprop_sw`` (Hu & Stamnes liquid; Ebert-Curry,
Key and Fu ice), clear and total sky for ``icld`` 0-3, McICA per-g-point
clouds (``spcvmc_sw``), and ECMWF or direct aerosol optics.  taumol's
interpolations, Rayleigh depths and solar sources are terms of three
kernel-B groups (``fused_mix.Group``, the key species over the merged
[absa; absb] table), one launch each for all bands, whose terms one
launch of the term-writer kernel (``term_writer``) writes on the card;
the delta-scaled two-stream solver and the adding method (``vrtqdr_sw``)
are plain torch with Python loops over levels.  Layers bottom-up, columns
trailing.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ... import data
from ...utils.profiling import phase
from . import fused_mix, term_writer

NBANDS = 14
NGPT = 112
NG = [6, 12, 8, 8, 10, 10, 2, 10, 8, 6, 6, 8, 6, 12]
NGS = np.concatenate([[0], np.cumsum(NG)])          # offsets into 112
NSPA = [9, 9, 9, 9, 1, 9, 9, 1, 9, 1, 0, 1, 9, 1]
NSPB = [1, 5, 1, 1, 1, 5, 1, 0, 1, 0, 0, 1, 5, 1]
NGB = np.concatenate([np.full(n, b) for b, n in enumerate(NG)])
# band wavenumber edges, bands 16..29 (sw_spectral.py:56)
WAVENUM2 = np.array([3250., 4000., 4650., 5150., 6150., 7700., 8050.,
                     12850., 16000., 22650., 29000., 38000., 50000.,
                     2600.])

ONEMINUS = 1.0 - 1.0e-6
# NRLSSI2 integration constants (sw_spectral.py:62-66)
IINT, FINT, SINT = 1360.37, 0.996047, -0.511590
FOFFSET, SOFFSET = 0.14959542, 0.00066696
SVAR_F_AVG, SVAR_S_AVG = 0.1568113, 909.21910
SVAR_CPRIM = FINT + SINT + IINT
RRSW_SCON = 1.36822e+03
AMD, AMW = 28.9660, 18.0160

# exponential transmittance lookup, copied from sw_spectral.py:70-75
NTBL, OD_LO, PADE, EXPEPS = 10000, 0.06, 0.278, 1.0e-20
BPADE = 1.0 / PADE
_tfn = np.arange(1, NTBL) / NTBL
EXP_TBL = np.concatenate(
    [[1.0], np.maximum(np.exp(-BPADE * _tfn / (1.0 - _tfn)), EXPEPS),
     [EXPEPS]])

# Band definitions, bands 16..29, copied from sw_spectral.py:88 (BANDS);
# keys as documented there.
BANDS = [
    dict(num=16, lo=('h2o', 'ch4', 252.131), up=('ch4',),
         self_lo=True, for_lo=True, for_up=False,
         sflux=('up', 0), layreffr=18, rayl='c'),
    dict(num=17, lo=('h2o', 'co2', 0.364641), up=('h2o', 'co2', 0.364641),
         self_lo=True, for_lo=True, for_up=True,
         sflux=('up', 4), layreffr=30, rayl='c'),
    dict(num=18, lo=('h2o', 'ch4', 38.9589), up=('ch4',),
         self_lo=True, for_lo=True, for_up=False,
         sflux=('lo', 8), layreffr=6, rayl='c'),
    dict(num=19, lo=('h2o', 'co2', 5.49281), up=('co2',),
         self_lo=True, for_lo=True, for_up=False,
         sflux=('lo', 8), layreffr=3, rayl='c'),
    dict(num=20, lo=('h2o',), up=('h2o',),
         self_lo=True, for_lo=True, for_up=True,
         extra=[('ch4', 'absch4', 'both')],
         sflux=('lo', 0), layreffr=3, rayl='c'),
    dict(num=21, lo=('h2o', 'co2', 0.0045321), up=('h2o', 'co2', 0.0045321),
         self_lo=True, for_lo=True, for_up=True,
         sflux=('lo', 8), layreffr=8, rayl='c'),
    dict(num=22, lo=('h2o', 'o2', 1.6 * 0.022708), up=('o2',),
         self_lo=True, for_lo=True, for_up=False, up_col_scale=1.6,
         o2cont=True, sflux=('lo', 8), layreffr=2, rayl='c'),
    dict(num=23, lo=('h2o',), up=None,
         self_lo=True, for_lo=True, for_up=False, kscale_lo=1.029,
         sflux=('lo', 0), layreffr=6, rayl='pg'),
    dict(num=24, lo=('h2o', 'o2', 0.124692), up=('o2',),
         self_lo=True, for_lo=True, for_up=False,
         extra=[('o3', 'abso3a', 'lo'), ('o3', 'abso3b', 'up')],
         sflux=('lo', 8), layreffr=1, rayl='b24'),
    dict(num=25, lo=('h2o',), up=None,
         self_lo=False, for_lo=False, for_up=False,
         extra=[('o3', 'abso3a', 'lo'), ('o3', 'abso3b', 'up')],
         sflux=('lo', 0), layreffr=2, rayl='pg'),
    dict(num=26, lo=None, up=None,
         self_lo=False, for_lo=False, for_up=False,
         sflux=('lo', 0), layreffr=0, rayl='pg'),
    dict(num=27, lo=('o3',), up=('o3',),
         self_lo=False, for_lo=False, for_up=False,
         sflux=('up', 0), layreffr=32, rayl='pg',
         sflux_scale=50.15 / 48.37),
    dict(num=28, lo=('o3', 'o2', 6.67029e-07), up=('o3', 'o2', 6.67029e-07),
         self_lo=False, for_lo=False, for_up=False,
         sflux=('up', 4), layreffr=58, rayl='c'),
    dict(num=29, lo=('h2o',), up=('co2',),
         self_lo=True, for_lo=True, for_up=False,
         extra=[('co2', 'absco2', 'lo'), ('h2o', 'absh2o', 'up')],
         sflux=('up', 0), layreffr=49, rayl='c'),
]


def load_tables():
    """rrtmg_sw_kdist.npz as a dict of numpy arrays, with the Pade table
    ``exp_tbl`` (:140)."""
    return dict(data.load_npz(data.SW_KDIST), exp_tbl=EXP_TBL)


def table_tensors(dtype, device):
    """rrtmg_sw_kdist.npz as tensors of ``dtype`` on ``device``
    (cached)."""
    return data.load_tensors(data.SW_KDIST, dtype, device)


def _trunc_int(x):
    return torch.trunc(x).to(torch.int32)


def setcoef_sw(pavel, tavel, coldry, wkl):
    """Interpolation indices/fractions and column amounts (:151)."""
    t = table_tensors(pavel.dtype, pavel.device)
    preflog, tref = t['preflog'], t['tref']
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

    trop = plog > 4.56
    water = wkl['h2o'] / coldry
    scalefac = pavel * stpfac / tavel
    forfac = scalefac / (1.0 + water)

    fac_lo = (332.0 - tavel) / 36.0
    indfor_lo = torch.clamp(_trunc_int(fac_lo), 1, 2)
    forfrac_lo = fac_lo - indfor_lo
    fac_up = (tavel - 188.0) / 36.0
    indfor = torch.where(trop, indfor_lo, 3) - 1
    forfrac = torch.where(trop, forfrac_lo, fac_up - 1.0)

    fac_s = (tavel - 188.0) / 7.2
    indself = torch.clamp(_trunc_int(fac_s) - 7, 1, 9) - 1
    selffrac = fac_s - (indself + 1 + 7)
    selffac = torch.where(trop, water * forfac, 0.0)
    selffrac = torch.where(trop, selffrac, 0.0)
    indself = torch.where(trop, indself, 0)

    cols = {}
    for gas in ('h2o', 'co2', 'o3', 'n2o', 'ch4', 'o2'):
        c = 1.0e-20 * wkl[gas]
        if gas not in ('h2o', 'o3'):           # Fortran floors these only
            c = torch.where(c == 0.0, 1.0e-32 * coldry, c)
        cols['col' + gas] = c
    cols['colmol'] = 1.0e-20 * coldry + cols['colh2o']

    compfp = 1.0 - fp
    return dict(
        trop=trop, jp=jp, jp0=jp0, jt0=jt0, jt10=jt10,
        fac00=compfp * (1.0 - ft), fac10=compfp * ft,
        fac01=fp * (1.0 - ft1), fac11=fp * ft1,
        selffac=selffac, selffrac=selffrac, indself=indself,
        forfac=forfac, forfrac=forfrac, indfor=indfor, **cols)


def _solar_mode(isolvar):
    return 'ref' if isolvar < 0 else ('svar' if isolvar <= 2 else 'band')


def solar_factors(isolvar, svar_f, svar_s, svar_i, svar_f_bnd, svar_s_bnd,
                  svar_i_bnd):
    """The solar source's factors by ``sw_term_plan``'s slots: three a
    band, the factor of its reference table (one of them) or of its
    facbrght, snsptdrk and irradnce tables."""
    mode = _solar_mode(isolvar)
    out = []
    for bi, bd in enumerate(BANDS):
        if mode == 'ref':
            out += [bd.get('sflux_scale', 1.0), 0.0, 0.0]
        elif mode == 'svar':
            out += [svar_f, svar_s, svar_i]
        else:
            out += [svar_f_bnd[bi], svar_s_bnd[bi], svar_i_bnd[bi]]
    return [float(x) for x in out]


def taumol_sw_terms(cs, isolvar, svar_f, svar_s, svar_i,
                    svar_f_bnd, svar_s_bnd, svar_i_bnd, dtype):
    """The terms of taumol (:247) as three kernel-B groups, unlaunched:
    taug and taur, (nz, ncol, 112) once run, and the solar source sflux,
    (ncol, 112).  Every band is one band of each group.
    ``term_writer.taumol_terms`` writes them from ``sw_term_plan``."""
    trop = cs['trop']
    nz, ncol = trop.shape
    mode = _solar_mode(isolvar)
    t = data.load_numpy(data.SW_KDIST)
    plan = term_writer.cached_plan(('sw', mode), t, dtype, trop.device,
                                   lambda: sw_term_plan(mode))
    groups = (fused_mix.Group('sw_taug', (nz, ncol), dtype, trop.device),
              fused_mix.Group('sw_taur', (nz, ncol), dtype, trop.device),
              fused_mix.Group(('sw_sflux', mode), (ncol,), dtype,
                              trop.device))
    return term_writer.taumol_terms(
        plan, groups, cs, factors=solar_factors(
            isolvar, svar_f, svar_s, svar_i, svar_f_bnd, svar_s_bnd,
            svar_i_bnd))


def sw_term_plan(solar_mode):
    """The term plan of ``taumol_sw_terms`` in ``solar_mode`` ('ref',
    'svar' or 'band'): the walk over ``BANDS`` that records each band's
    terms as entries (``term_writer.TermPlan``), group 0 taug, 1 taur, 2
    the solar source, whose factors ``solar_factors`` gives by slot."""
    taug, taur, sflux = 0, 1, 2
    t = data.load_numpy(data.SW_KDIST)
    plan = term_writer.TermPlan(3, columns=(sflux,))
    f, i = plan.field, plan.int_field
    no_mask, trop_mask, upper = (term_writer.NO_MASK, term_writer.TROP,
                                 term_writer.UPPER)

    def spec(s):
        """(field ids of columns 1 and 2, the ratio) of a key-species
        tuple."""
        if s is None:
            return [-1, -1], 0.0
        if len(s) == 1:
            return [f('col' + s[0]), -1], 0.0
        return [f('col' + s[0]), f('col' + s[1])], s[2]

    for bi, bd in enumerate(BANDS):
        num, ng = bd['num'], NG[bi]

        def tab(name, b=num):
            return t.get('b%d_%s' % (b, name))

        lo, lo_ratio = spec(bd['lo'])
        up, up_ratio = spec(bd['up'])
        plan.band(taug, ng)
        have_lo = bd['lo'] is not None
        have_up = bd['up'] is not None
        if have_lo or have_up:
            rows_a = 0
            if have_lo and have_up:
                plan.part(taug, np.concatenate([tab('absa'), tab('absb')],
                                               axis=0))
                rows_a = tab('absa').shape[0]
            else:
                plan.part(taug, tab('absa') if have_lo else tab('absb'))
            nspa, nspb = NSPA[bi], NSPB[bi]
            scale, kscale = bd.get('up_col_scale'), bd.get('kscale_lo')
            plan.entry('sw_key', taug, [nspa, nspb, rows_a] + lo + up
                       + [int(bool(scale)), int(bool(kscale))],
                       [lo_ratio, up_ratio, scale or 0.0, kscale or 0.0],
                       nterms=8 if (nspa == 9 or nspb == 5) else 4)

        if bd['self_lo'] or bd['for_lo'] or bd['for_up']:
            if bd['self_lo']:
                plan.part(taug, tab('selfref'))
                plan.entry('sw_self', taug, [i('indself'), f('selffrac'),
                                             f('selffac'), f('colh2o')],
                           nterms=2)
            mask = (no_mask if bd['for_lo'] and bd['for_up']
                    else trop_mask if bd['for_lo'] else upper)
            plan.part(taug, tab('forref'))
            plan.entry('sw_for', taug, [i('indfor'), f('forfrac'),
                                        f('forfac'), f('colh2o'), mask],
                       nterms=2)

        for gas, table_name, regime in bd.get('extra', ()):
            plan.part(taug, tab(table_name))
            plan.entry('row_col', taug, [f('col' + gas), dict(
                both=no_mask, lo=trop_mask, up=upper)[regime]], nterms=1)
        if bd.get('o2cont'):
            plan.part(taug, np.ones(ng))
            plan.entry('row_o2', taug, [f('colo2')], nterms=1)

        plan.band(taur, ng)
        if bd['rayl'] in ('c', 'pg'):
            plan.part(taur, tab('rayl'))
            plan.entry('row_col', taur, [f('colmol'), no_mask], nterms=1)
        else:  # band 24: eta-interpolated lower, raylb upper
            plan.part(taur, tab('rayla').T)
            plan.entry('lin_eta', taur, lo + [f('colmol'), trop_mask, 8],
                       [lo_ratio], nterms=2)
            plan.part(taur, tab('raylb'))
            plan.entry('row_col', taur, [f('colmol'), upper], nterms=1)

        where, neta = bd['sflux']
        plan.band(sflux, ng)
        key, ratio = (lo, lo_ratio) if where == 'lo' else (up, up_ratio)
        plan.entry('sol_layer', sflux, [int(where == 'up'), bd['layreffr'],
                                        int(bool(neta))] + key
                   + [8 if where == 'lo' else 4], [ratio])
        names = (['sfluxref'] if solar_mode == 'ref'
                 else ['facbrght', 'snsptdrk', 'irradnce'])
        for slot, name in enumerate(names):
            if neta == 0:
                plan.part(sflux, tab(name))
                plan.entry('sol_row', sflux, [3 * bi + slot], nterms=1)
            else:
                plan.part(sflux, tab(name).T)
                plan.entry('sol_lin', sflux, [3 * bi + slot], nterms=2)
    return plan


def taumol_sw(cs, isolvar, svar_f, svar_s, svar_i,
              svar_f_bnd, svar_s_bnd, svar_i_bnd, dtype):
    """Gaseous + Rayleigh optical depth and solar source per g-point
    (:247).  Returns taug, taur (nz, ncol, 112) and sflux (ncol, 112),
    one kernel-B launch each."""
    return tuple(g.run() for g in taumol_sw_terms(
        cs, isolvar, svar_f, svar_s, svar_i, svar_f_bnd, svar_s_bnd,
        svar_i_bnd, dtype))


@functools.lru_cache()
def _exp_table(dtype, device):
    return torch.as_tensor(EXP_TBL, dtype=dtype, device=device)


def _tbl_index(ze1):
    """Row of the exponential table for ze1 (:493-494), with JAX's gather
    semantics for rows outside the table (a negative optical depth, where
    the quadratic is taken anyway): a negative row counts from the end,
    then the row is clamped to the table."""
    i = _trunc_int(NTBL * (ze1 / (BPADE + ze1)) + 0.5).long()
    return torch.clamp(torch.where(i < 0, i + (NTBL + 1), i), 0, NTBL)


def _exp_transmittance(tau, use_tables=True):
    """exp(-tau) through the Pade lookup table, a quadratic below OD_LO
    (:474); with use_tables=False exp(-tau) itself, clamped at the
    table's EXPEPS floor."""
    ze1 = torch.clamp(tau, max=500.0)
    if not use_tables:
        return torch.clamp(torch.exp(-ze1), min=EXPEPS)
    small = 1.0 - ze1 + 0.5 * ze1 * ze1
    lut = _exp_table(tau.dtype, tau.device)[_tbl_index(ze1)]
    return torch.where(ze1 <= OD_LO, small, lut)


def reftra_sw(tau, omega, g, mu0, active, use_tables=True):
    """Two-stream reflectance/transmittance, kmodts=2 (:499).
    Returns (ref, refd, tra, trad)."""
    eps = 1.0e-8
    zwcrit = 0.9999995
    zg3 = 3.0 * g
    gamma1 = (8.0 - omega * (5.0 + zg3)) * 0.25
    gamma2 = 3.0 * (omega * (1.0 - g)) * 0.25
    gamma3 = (2.0 - zg3 * mu0) * 0.25
    gamma4 = 1.0 - gamma3

    zwo = omega / (1.0 - (1.0 - omega) * (g / (1.0 - g)) ** 2)
    conservative = zwo >= zwcrit

    za = gamma1 * mu0
    za1 = za - gamma3
    zgt = gamma1 * tau
    ze2c = _exp_transmittance(tau / mu0, use_tables)
    ref_c = torch.where(ze2c == 1.0, 0.0,
                        (zgt - za1 * (1.0 - ze2c)) / (1.0 + zgt))
    tra_c = 1.0 - ref_c
    refd_c = torch.where(ze2c == 1.0, 0.0, zgt / (1.0 + zgt))
    trad_c = 1.0 - refd_c

    za1n = gamma1 * gamma4 + gamma2 * gamma3
    za2n = gamma1 * gamma3 + gamma2 * gamma4
    zrk = torch.sqrt(torch.clamp(gamma1 * gamma1 - gamma2 * gamma2,
                                 min=eps * eps))
    zrp = zrk * mu0
    zrp1 = 1.0 + zrp
    zrm1 = 1.0 - zrp
    zrk2 = 2.0 * zrk
    zrpp = 1.0 - zrp * zrp
    zrkg = zrk + gamma1
    zr1 = zrm1 * (za2n + zrk * gamma3)
    zr2 = zrp1 * (za2n - zrk * gamma3)
    zr3 = zrk2 * (gamma3 - za2n * mu0)
    zr4 = zrpp * zrkg
    zr5 = zrpp * (zrk - gamma1)
    zt1 = zrp1 * (za1n + zrk * gamma4)
    zt2 = zrm1 * (za1n - zrk * gamma4)
    zt3 = zrk2 * (gamma4 + za1n * mu0)
    zbeta = (gamma1 - zrk) / zrkg

    zem1 = _exp_transmittance(torch.clamp(zrk * tau, max=500.0), use_tables)
    zep1 = 1.0 / zem1
    zem2 = _exp_transmittance(torch.clamp(tau / mu0, max=500.0), use_tables)
    zep2 = 1.0 / zem2

    zdenr = zr4 * zep1 + zr5 * zem1
    zdent = zdenr
    denr_small = torch.abs(zdenr) <= eps
    ref_n = torch.where(
        denr_small, eps,
        omega * (zr1 * zep1 - zr2 * zem1 - zr3 * zem2)
        / torch.where(denr_small, 1.0, zdenr))
    tra_n = torch.where(
        denr_small, zem2,
        zem2 - zem2 * omega * (zt1 * zep1 - zt2 * zem1 - zt3 * zep2)
        / torch.where(denr_small, 1.0, zdent))
    zemm = zem1 * zem1
    zdend = 1.0 / ((1.0 - zbeta * zemm) * zrkg)
    refd_n = gamma2 * (1.0 - zemm) * zdend
    trad_n = zrk2 * zem1 * zdend

    ref = torch.where(conservative, ref_c, ref_n)
    refd = torch.where(conservative, refd_c, refd_n)
    tra = torch.where(conservative, tra_c, tra_n)
    trad = torch.where(conservative, trad_c, trad_n)

    return (torch.where(active, ref, 0.0), torch.where(active, refd, 0.0),
            torch.where(active, tra, 1.0), torch.where(active, trad, 1.0))


def vrtqdr_sw(ref, refd, tra, trad, dbt, tdbt, alb_dir, alb_dif):
    """Adding method (:581), loops over levels.  Layer arrays (nz, ...)
    TOP-DOWN; level arrays (nz+1, ...) with 0 = TOA.  Returns (fd, fu)."""
    nz = ref.shape[0]
    surf_ref = alb_dir.expand(ref.shape[1:])
    surf_refd = alb_dif.expand(ref.shape[1:])

    # upward pass: prup/prupd from the surface to TOA
    prup = [None] * (nz + 1)
    prupd = [None] * (nz + 1)
    prup[nz], prupd[nz] = surf_ref, surf_refd
    for k in range(nz - 1, -1, -1):
        zreflect = 1.0 / (1.0 - prupd[k + 1] * refd[k])
        prup[k] = ref[k] + (trad[k] * ((tra[k] - dbt[k]) * prupd[k + 1]
                                       + dbt[k] * prup[k + 1])) * zreflect
        prupd[k] = refd[k] + trad[k] * trad[k] * prupd[k + 1] * zreflect
    prup = torch.stack(prup)
    prupd = torch.stack(prupd)

    # downward pass: ztdn/prdnd from TOA to the surface
    ztdn = [torch.ones_like(surf_ref)]
    prdnd = [torch.zeros_like(surf_ref)]
    for k in range(nz):
        zreflect = 1.0 / (1.0 - refd[k] * prdnd[k])
        ztdn.append(tdbt[k] * tra[k] + (trad[k] * (
            (ztdn[k] - tdbt[k]) + tdbt[k] * ref[k] * prdnd[k])) * zreflect)
        prdnd.append(refd[k] + trad[k] * trad[k] * prdnd[k] * zreflect)
    ztdn = torch.stack(ztdn)
    prdnd = torch.stack(prdnd)

    zreflect = 1.0 / (1.0 - prdnd * prupd)
    fu = (tdbt * prup + (ztdn - tdbt) * prupd) * zreflect
    fd = tdbt + (ztdn - tdbt + tdbt * prup * prdnd) * zreflect
    return fd, fu


def _lin_rows(table, i0, fint):
    """table[i0] + fint * (table[i0 + 1] - table[i0]), rows by band."""
    lo = table[i0]
    return lo + fint * (table[i0 + 1] - lo)


def cldprop_sw(inflag, iceflag, liqflag, cldfrac, tauc, ssac, asmc, fsfc,
               ciwp, clwp, rei, rel, dtype=None):
    """Cloud optical properties per band (:633): direct input (inflag 0)
    or Hu & Stamnes liquid with Ebert-Curry (iceflag 1), Key (2) or Fu
    (3) ice (inflag 2).  Arrays (nz, ncol[, nband]); returns (taucloud,
    ssacloud, asmcloud, taucldorig), each (nz, ncol, nband), with the
    tables read and the results cast to ``dtype`` as in JAX (None: the
    inputs' dtype, uncast).  liqflag selects nothing: the liquid optics
    are always Hu & Stamnes, as in JAX."""
    t = table_tensors(dtype or cldfrac.dtype, cldfrac.device)
    cldmin = 1.0e-20
    cloudy = (cldfrac >= cldmin)[..., None]

    def out(*xs):
        return xs if dtype is None else tuple(x.to(dtype) for x in xs)

    if inflag == 0:
        ffp = fsfc
        ffp1 = 1.0 - ffp
        ffpssa = 1.0 - ffp * ssac
        ssacloud = ffp1 * ssac / ffpssa
        taucloud = ffpssa * tauc
        asmcloud = (asmc - ffp) / ffp1
        sel = cloudy & (torch.sum(tauc, -1, keepdim=True) >= cldmin)
        return out(torch.where(sel, taucloud, 0.0),
                   torch.where(sel, ssacloud, 1.0),
                   torch.where(sel, asmcloud, 0.0),
                   torch.where(sel, tauc, 0.0))
    if inflag != 2:
        raise ValueError('shortwave cldprop supports inflag 0 or 2')

    # ice optics
    radice = rei[..., None]
    if iceflag == 1:
        icx = torch.as_tensor(np.searchsorted(
            -np.array([1.43e4, 7.7e3, 5.3e3, 4.0e3]), -WAVENUM2),
            device=cldfrac.device)          # 0..4 per band
        extcoice = t['cld_abari'][icx] + t['cld_bbari'][icx] / radice
        ssacoice = 1.0 - t['cld_cbari'][icx] - t['cld_dbari'][icx] * radice
        gice = torch.clamp(t['cld_ebari'][icx] + t['cld_fbari'][icx]
                           * radice, max=1.0 - 1e-6)
        forwice = gice * gice
    else:
        names = (('extice2', 'ssaice2', 'asyice2') if iceflag == 2
                 else ('extice3', 'ssaice3', 'asyice3', 'fdlice3'))
        tabs = [t['cld_' + n] for n in names]
        factor = (rei - 2.0) / 3.0
        index = torch.clamp(_trunc_int(factor), max=42 if iceflag == 2
                            else 45)
        fint = (factor - index)[..., None]
        i0 = torch.clamp(index - 1, 0, tabs[0].shape[0] - 2).long()
        rows = [_lin_rows(tab, i0, fint) for tab in tabs]
        extcoice, ssacoice, gice = rows[:3]
        if iceflag == 2:
            forwice = gice * gice
        else:
            forwice = torch.minimum(rows[3] + 0.5 / ssacoice, gice)

    no_ice = (ciwp == 0.0)[..., None]
    extcoice = torch.where(no_ice, 0.0, extcoice)
    ssacoice = torch.where(no_ice, 0.0, ssacoice)
    gice = torch.where(no_ice, 0.0, gice)
    forwice = torch.where(no_ice, 0.0, forwice)

    # liquid optics (Hu & Stamnes, radius dependent)
    index = torch.clamp(_trunc_int(rel - 1.5), 1, 57)
    fint = (rel - 1.5 - index)[..., None]
    i0 = (index - 1).long()
    ssal = t['cld_ssaliq1']
    extcoliq = _lin_rows(t['cld_extliq1'], i0, fint)
    ssacoliq = _lin_rows(ssal, i0, fint)
    ssacoliq = torch.where((fint < 0.0) & (ssacoliq > 1.0), ssal[i0],
                           ssacoliq)
    gliq = _lin_rows(t['cld_asyliq1'], i0, fint)
    forwliq = gliq * gliq
    no_liq = (clwp == 0.0)[..., None]
    extcoliq = torch.where(no_liq, 0.0, extcoliq)
    ssacoliq = torch.where(no_liq, 0.0, ssacoliq)
    gliq = torch.where(no_liq, 0.0, gliq)
    forwliq = torch.where(no_liq, 0.0, forwliq)

    tauliqorig = clwp[..., None] * extcoliq
    tauiceorig = ciwp[..., None] * extcoice
    taucldorig = tauliqorig + tauiceorig
    den_l = 1.0 - forwliq * ssacoliq
    ssaliq = ssacoliq * (1.0 - forwliq) / den_l
    tauliq = den_l * tauliqorig
    den_i = torch.where(forwice * ssacoice == 1.0, 1.0,
                        1.0 - forwice * ssacoice)
    ssaice = torch.where(no_ice, 0.0, ssacoice * (1.0 - forwice) / den_i)
    tauice = den_i * tauiceorig
    scatliq = ssaliq * tauliq
    scatice = ssaice * tauice
    taucloud = tauliq + tauice
    taucloud = torch.where(taucloud == 0.0, cldmin, taucloud)
    scatice = torch.where(scatice == 0.0, cldmin, scatice)
    ssacloud = (scatliq + scatice) / taucloud
    g_l = (gliq - forwliq) / torch.where(forwliq == 1.0, 1.0, 1.0 - forwliq)
    g_i = (gice - forwice) / torch.where(forwice == 1.0, 1.0, 1.0 - forwice)
    asmcloud = (scatliq * g_l + scatice * g_i) / (scatliq + scatice)

    sel = cloudy & ((ciwp + clwp >= cldmin)[..., None])
    return out(torch.where(sel, taucloud, 0.0),
               torch.where(sel, ssacloud, 1.0),
               torch.where(sel, asmcloud, 0.0),
               torch.where(sel, taucldorig, 0.0))


def _top_down_g(x, ngb):
    """(nz, ncol, nband) bottom-up -> (nz, ncol, 112) top-down."""
    return torch.flip(x, [0])[:, :, ngb]


def _incident_flux(adjflux_band, sflux, mu0, ngb):
    adj = torch.as_tensor(np.asarray(adjflux_band), dtype=sflux.dtype,
                          device=sflux.device)
    return adj[ngb] * sflux * mu0[:, None]


def _clear_optics(taur, taug, taua, omga, asya):
    """Delta-scaled clear-sky optics (spcvrt_sw.f90): (tau, omega, g)."""
    ztauc = taur + taug + taua
    zomcc = taur * 1.0 + taua * omga
    zgcc = asya * omga * taua / torch.clamp(zomcc, min=1e-300)
    zomcc = zomcc / ztauc
    zf = zgcc * zgcc
    zwf = zomcc * zf
    return ((1.0 - zwf) * ztauc, (zomcc - zwf) / (1.0 - zwf),
            (zgcc - zf) / (1.0 - zf))


def spcvrt_sw(taug, taur, sflux, adjflux_band, mu0, alb_dir_band,
              alb_dif_band, cldfrac, tauc_b, ssac_b, asmc_b,
              taua_b, ssaa_b, asma_b, icld, use_tables=True):
    """Two-stream solver over all g-points (:760).  taug/taur (nz, ncol,
    112) bottom-up, sflux (ncol, 112), band optics (nz, ncol, nband).
    Returns (fd, fu, fd_clear, fu_clear): (nz+1, ncol) bottom-up."""
    ngb = torch.as_tensor(NGB, dtype=torch.int64, device=taug.device)
    taug = torch.flip(taug, [0])                      # top-down
    taur = torch.flip(taur, [0])
    taua = _top_down_g(taua_b, ngb)
    omga = _top_down_g(ssaa_b, ngb)
    asya = _top_down_g(asma_b, ngb)
    mu0b = mu0[None, :, None]
    incflx = _incident_flux(adjflux_band, sflux, mu0, ngb)
    ztauc_d, zomcc_d, zgcc_d = _clear_optics(taur, taug, taua, omga, asya)
    if icld == 0:
        return _spcv_core(ztauc_d, zomcc_d, zgcc_d, None, None, None, None,
                          mu0b, alb_dir_band, alb_dif_band, incflx, icld,
                          use_tables)

    # total-sky optics (icpr=0 path: combine unscaled, then delta scale)
    cf = torch.flip(cldfrac, [0])[..., None]          # (nz, ncol, 1)
    tauc = _top_down_g(tauc_b, ngb)
    omgc = _top_down_g(ssac_b, ngb)
    asyc = _top_down_g(asmc_b, ngb)
    ztauo = taur + taug + taua + tauc
    zomco = taua * omga + tauc * omgc + taur * 1.0
    zgco = (tauc * omgc * asyc + taua * omga * asya) / torch.clamp(
        zomco, min=1e-300)
    zomco = zomco / ztauo
    zfo = zgco * zgco
    zwfo = zomco * zfo
    return _spcv_core(ztauc_d, zomcc_d, zgcc_d, (1.0 - zwfo) * ztauo,
                      (zomco - zwfo) / (1.0 - zwfo),
                      (zgco - zfo) / (1.0 - zfo), cf, mu0b, alb_dir_band,
                      alb_dif_band, incflx, icld, use_tables)


def _spcv_core(ztauc_d, zomcc_d, zgcc_d, ztauo_d, zomco_d, zgco_d, cf,
               mu0b, alb_dir_band, alb_dif_band, incflx, icld,
               use_tables=True):
    """Two-stream tail of spcvrt/spcvmc (:817): reflectivities, direct
    beam, clear/cloudy combination and the adding sweeps.  Optics
    top-down (nz, ncol, 112), delta-scaled; cf the cloud fraction (nz,
    ncol, 1) or McICA's 0/1 subcolumn mask (nz, ncol, 112).  With icld 0
    the total sky is the clear sky: one sweep, no cloud optics."""
    ncol = ztauc_d.shape[1]
    ngb = torch.as_tensor(NGB, dtype=torch.int64, device=ztauc_d.device)
    refc, refdc, trac, tradc = reftra_sw(
        ztauc_d, zomcc_d, zgcc_d, mu0b,
        torch.ones_like(ztauc_d, dtype=torch.bool), use_tables)
    zdbtc = _exp_transmittance(ztauc_d / mu0b, use_tables)
    ones_lvl = torch.ones((1, ncol, NGPT), dtype=ztauc_d.dtype,
                          device=ztauc_d.device)
    ztdbtc = torch.cat([ones_lvl, torch.cumprod(zdbtc, dim=0)], dim=0)
    albp = alb_dir_band[:, ngb]
    albd = alb_dif_band[:, ngb]
    fd_c, fu_c = vrtqdr_sw(refc, refdc, trac, tradc, zdbtc, ztdbtc,
                           albp, albd)

    def total(f):
        return torch.flip(torch.einsum('lcg,cg->lc', f, incflx), [0])

    if icld == 0:
        fd, fu = total(fd_c), total(fu_c)
        return fd, fu, fd, fu

    refo, refdo, trao, trado = reftra_sw(
        ztauo_d, zomco_d, zgco_d, mu0b, cf > 1e-12, use_tables)
    zdbto = _exp_transmittance(ztauo_d / mu0b, use_tables)
    clr = 1.0 - cf
    zdbt = clr * zdbtc + cf * zdbto
    ztdbt = torch.cat([ones_lvl, torch.cumprod(zdbt, dim=0)], dim=0)
    fd_t, fu_t = vrtqdr_sw(
        clr * refc + cf * refo, clr * refdc + cf * refdo,
        clr * trac + cf * trao, clr * tradc + cf * trado, zdbt, ztdbt,
        albp, albd)
    return total(fd_t), total(fu_t), total(fd_c), total(fu_c)


def spcvmc_sw(taug, taur, sflux, adjflux_band, mu0, alb_dir_band,
              alb_dif_band, cldfmc_g, taucmc_g, ssacmc_g, asmcmc_g,
              taua_b, ssaa_b, asma_b, use_tables=True):
    """McICA two-stream solver (:876, the icpr=1 path): per-g-point
    subcolumn cloud optics (nz, ncol, 112) bottom-up, already
    delta-scaled, combined with the delta-scaled clear column; the 0/1
    subcolumn mask weights clear and cloudy."""
    ngb = torch.as_tensor(NGB, dtype=torch.int64, device=taug.device)
    taug = torch.flip(taug, [0])
    taur = torch.flip(taur, [0])
    cf, tauc, omgc, asyc = (torch.flip(x, [0]) for x in (
        cldfmc_g, taucmc_g, ssacmc_g, asmcmc_g))
    taua = _top_down_g(taua_b, ngb)
    omga = _top_down_g(ssaa_b, ngb)
    asya = _top_down_g(asma_b, ngb)
    mu0b = mu0[None, :, None]
    incflx = _incident_flux(adjflux_band, sflux, mu0, ngb)
    ztauc_d, zomcc_d, zgcc_d = _clear_optics(taur, taug, taua, omga, asya)
    ztauo_d = ztauc_d + tauc
    zomco_raw = ztauc_d * zomcc_d + tauc * omgc
    zgco_d = (tauc * omgc * asyc + ztauc_d * zomcc_d * zgcc_d) \
        / torch.clamp(zomco_raw, min=1e-300)
    return _spcv_core(ztauc_d, zomcc_d, zgcc_d, ztauo_d,
                      zomco_raw / ztauo_d, zgco_d, cf, mu0b, alb_dir_band,
                      alb_dif_band, incflx, 1, use_tables)


def ecmwf_aerosol_optics(ecaer, dtype=None):
    """ECMWF six-type aerosol optical depth at 0.55 micron, (6, nz, ncol),
    to band optics (taua, ssaa, asma), each (nz, ncol, nband) (:1090):
    the tables read in ``dtype`` (None: ecaer's), the products in the
    promotion of the two, as in JAX."""
    t = table_tensors(dtype or ecaer.dtype, ecaer.device)
    rsrtaua = t['aer_rsrtaua']                        # (nband, naer)
    rsrpiza = t['aer_rsrpiza']
    rsrasya = t['aer_rsrasya']
    work = torch.promote_types(ecaer.dtype, rsrtaua.dtype)
    ec = torch.movedim(ecaer, 0, -1).to(work)         # (nz, ncol, naer)
    taua, zomga, zasya = (
        torch.einsum('zca,ba->zcb', ec, x.to(work))
        for x in (rsrtaua, rsrtaua * rsrpiza, rsrtaua * rsrpiza * rsrasya))
    asma = torch.where(zomga != 0.0,
                       zasya / torch.where(zomga == 0, 1.0, zomga), zasya)
    ssaa = torch.where(taua != 0.0,
                       zomga / torch.where(taua == 0, 1.0, taua), 1.0)
    return taua, ssaa, asma


def earth_sun(day_of_year):
    """Earth-sun distance flux factor (:931)."""
    gamma = 2.0 * np.pi * (day_of_year - 1) / 365.0
    return (1.000110 + 0.034221 * np.cos(gamma) + 0.001289 * np.sin(gamma)
            + 0.000719 * np.cos(2.0 * gamma)
            + 0.000077 * np.sin(2.0 * gamma))


def solar_variability(isolvar, scon, solcycfrac=0.0, indsolvar=(1.0, 1.0),
                      bndsolvar=None):
    """svar_f/s/i factors and per-band adjustments (:939), plain numpy.

    Returns (svar_f, svar_s, svar_i, svar_f_bnd, svar_s_bnd, svar_i_bnd,
    solvar_band)."""
    t = data.load_numpy(data.SW_KDIST)
    svar_f = svar_s = svar_i = 1.0
    svar_bnd = [np.ones(NBANDS)] * 3
    solvar = np.ones(NBANDS)
    ind1, ind2 = float(indsolvar[0]), float(indsolvar[1])
    sf = float(solcycfrac)

    if (ind1 != 1.0 or ind2 != 1.0) and isolvar == 1:
        if 0.0 <= sf < 0.0229:
            wgt = (sf + 1.0 - 0.3817) / (1.0229 - 0.3817)
            ind1, ind2 = (v + wgt * (1.0 - v) for v in (ind1, ind2))
        elif 0.0229 <= sf <= 0.3817:
            wgt = (sf - 0.0229) / (0.3817 - 0.0229)
            ind1, ind2 = (1.0 + wgt * (v - 1.0) for v in (ind1, ind2))
        elif sf <= 1.0:
            wgt = (sf - 0.3817) / (1.0229 - 0.3817)
            ind1, ind2 = (v + wgt * (1.0 - v) for v in (ind1, ind2))

    def cyc_interp():
        mg, sb = t['mgavgcyc'], t['sbavgcyc']
        n = len(mg)
        if sf <= 0.0:
            return mg[0], sb[0]
        if sf >= 1.0:
            return mg[-1], sb[-1]
        sfid = int(np.floor(sf * (n - 1))) + 1
        fraclo = (sfid - 1) / (n - 1)
        frachi = sfid / (n - 1)
        intfrac = (sf - fraclo) / (frachi - fraclo)
        a = mg[sfid - 1] + intfrac * (mg[sfid] - mg[sfid - 1])
        b = sb[sfid - 1] + intfrac * (sb[sfid] - sb[sfid - 1])
        return a, b

    if scon == 0.0:
        if isolvar == 0:
            svar_f = svar_s = svar_i = 1.0
        elif isolvar == 1:
            a, b = cyc_interp()
            svar_f = ind1 * (a - FOFFSET) / (SVAR_F_AVG - FOFFSET)
            svar_s = ind2 * (b - SOFFSET) / (SVAR_S_AVG - SOFFSET)
            svar_i = 1.0
        elif isolvar == 2:
            svar_f = (ind1 - FOFFSET) / (SVAR_F_AVG - FOFFSET)
            svar_s = (ind2 - SOFFSET) / (SVAR_S_AVG - SOFFSET)
            svar_i = 1.0
        elif isolvar == 3:
            sb = np.ones(NBANDS) if bndsolvar is None else np.asarray(
                bndsolvar)[:NBANDS]
            svar_bnd = [sb, sb, sb]
        if isolvar == -1 and bndsolvar is not None:
            solvar = np.asarray(bndsolvar)[:NBANDS]
    else:
        if isolvar == -1:
            solvar = np.full(NBANDS, scon / RRSW_SCON)
            if bndsolvar is not None:
                solvar = np.asarray(bndsolvar)[:NBANDS] * scon / RRSW_SCON
        elif isolvar == 0:
            svar_f = svar_s = svar_i = scon / SVAR_CPRIM
        elif isolvar == 1:
            a, b = cyc_interp()
            svar_i = (scon - (ind1 * FINT + ind2 * SINT)) / IINT
            svar_f = ind1 * (a - FOFFSET) / (SVAR_F_AVG - FOFFSET)
            svar_s = ind2 * (b - SOFFSET) / (SVAR_S_AVG - SOFFSET)
        elif isolvar == 3:
            sb = np.ones(NBANDS) if bndsolvar is None else np.asarray(
                bndsolvar)[:NBANDS]
            sb = sb * scon / SVAR_CPRIM
            svar_bnd = [sb, sb, sb]
    return (svar_f, svar_s, svar_i, svar_bnd[0], svar_bnd[1], svar_bnd[2],
            solvar)


def gas_coefs_sw(play, plev, tlay, h2ovmr, o3vmr, co2vmr, ch4vmr,
                 n2ovmr, o2vmr, grav, avogadro):
    """Column amounts and setcoef of rrtmg_sw_fluxes: the interpolation
    coefficients that taumol reads."""
    pdp = plev[:-1] - plev[1:]
    amm = (1.0 - h2ovmr) * AMD + h2ovmr * AMW
    coldry = pdp * 1.0e3 * avogadro / (
        1.0e2 * grav * amm * (1.0 + h2ovmr))
    wkl = {g: vmr * coldry for g, vmr in (
        ('h2o', h2ovmr), ('co2', co2vmr), ('o3', o3vmr),
        ('n2o', n2ovmr), ('ch4', ch4vmr), ('o2', o2vmr))}
    return setcoef_sw(play, tlay, coldry, wkl)


def rrtmg_sw_fluxes(play, plev, tlay, h2ovmr, o3vmr, co2vmr, ch4vmr,
                    n2ovmr, o2vmr, asdir, asdif, aldir, aldif, coszen,
                    cldfrac, cloud_optics, aerosol_optics,
                    adjes, day_of_year, scon, isolvar,
                    solar_config, grav, avogadro, cpdair, icld,
                    per_g_cloud=False, cloud_g=None, use_tables=True):
    """Full shortwave driver (:1018).  Pressures in mb, (nz, ncol)
    bottom-up; coszen (ncol,); cloud_optics (tauc, ssac, asmc, taucorig)
    and aerosol_optics (taua, ssaa, asma) per band (nz, ncol, nband).
    With per_g_cloud, cloud_g = (cldfmc, taucmc, ssacmc, asmcmc), McICA
    subcolumn optics (nz, ncol, 112), replace the band clouds and the
    solver is spcvmc.  Returns (swuflx, swdflx, swuflxc, swdflxc) on
    (nz+1, ncol) levels plus (swhr, swhrc) in K/day."""
    dtype = play.dtype
    (svar_f, svar_s, svar_i, svf_b, svs_b, svi_b, solvar) = solar_config
    adjflx = earth_sun(day_of_year) if day_of_year > 0 else adjes
    if isolvar < 0:
        adjflux_band = adjflx * np.asarray(solvar)
    else:
        adjflux_band = adjflx * np.ones(NBANDS)

    cossza = torch.clamp(coszen, min=1.0e-10)

    pdp = plev[:-1] - plev[1:]
    with phase('climt.gas_optics'):
        cs = gas_coefs_sw(play, plev, tlay, h2ovmr, o3vmr, co2vmr, ch4vmr,
                          n2ovmr, o2vmr, grav, avogadro)
        taug, taur, sflux = taumol_sw(
            cs, isolvar, svar_f, svar_s, svar_i, svf_b, svs_b, svi_b, dtype)

    # band albedos: NIR bands 16-24 & 29, UV/vis 25-28 (rad.f90:648-659)
    alb_dir = torch.stack([aldir] * 9 + [asdir] * 4 + [aldir], dim=-1)
    alb_dif = torch.stack([aldif] * 9 + [asdif] * 4 + [aldif], dim=-1)
    tauc_b, ssac_b, asmc_b, _ = cloud_optics
    taua_b, ssaa_b, asma_b = aerosol_optics
    with phase('climt.sw_solver'):
        if per_g_cloud:
            fd, fu, fdc, fuc = spcvmc_sw(
                taug, taur, sflux, adjflux_band, cossza, alb_dir, alb_dif,
                *cloud_g, taua_b, ssaa_b, asma_b, use_tables=use_tables)
        else:
            fd, fu, fdc, fuc = spcvrt_sw(
                taug, taur, sflux, adjflux_band, cossza, alb_dir, alb_dif,
                cldfrac, tauc_b, ssac_b, asmc_b, taua_b, ssaa_b, asma_b,
                icld, use_tables=use_tables)

    heatfac = grav * 86400.0 * 1.0e-5 / (cpdair * 1.0e-3)
    net = fd - fu
    netc = fdc - fuc
    swhr = heatfac * (net[1:] - net[:-1]) / pdp
    swhrc = heatfac * (netc[1:] - netc[:-1]) / pdp
    return fu, fd, fuc, fdc, swhr, swhrc
