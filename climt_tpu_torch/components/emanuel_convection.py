"""Emanuel-Zivkovic-Rothman buoyancy-sorting convection (v4.3c) on
tensors (climt_tpu/components/emanuel_convection.py).

``emanuel_convect`` runs the plain version below on CPU tensors and the
hand-written kernel ``csrc/emanuel.cu`` on CUDA tensors (float32 or
float64, at most ``MAX_NZ`` levels), one launch a call.

The plain version has the same whole-grid formulation as the JAX module:
per-column integer levels (nk, icb, inb) are index tensors,
level-dependent regions are masks, the (level x level) mixing matrix is
dense, and the few sequential vertical recurrences (minimum-MSE search,
running CAPE, running SMIN, the precipitating downdraft) are Python loops
over levels with all columns batched.  Arrays are (ncol, nz), bottom-up.
The kernel computes the same in one warp a column (see its source note).
``EmanuelConvection`` is the climt component over it, computing on its
``device``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..core.base_components import (ImplicitTendencyComponent,
                                    timestep_seconds)
from ..core.constants import get_constant
from ..core.dataarray import as_tensor
from ..core.util import bolton_q_sat, resolve_device

_EPMAX = 0.999
# the kernel gives a column's levels one lane each of a warp
MAX_NZ = 32
# the kernel's scalar parameters, in the order of csrc/emanuel.cu's Params
KERNEL_PARAMS = ('cpd', 'cpv', 'cl', 'rv', 'rd', 'lv0', 'g', 'rowl', 'sigd',
                 'sigs', 'entp', 'elcrit', 'tlcrit', 'omtrain', 'omtsnow',
                 'coeffr', 'coeffs', 'cu', 'beta', 'dtmax', 'alpha', 'damp',
                 'delt0')


def _take_level(arr, idx):
    """arr (ncol, nz), idx (ncol,) -> arr[col, idx[col]] (:45)."""
    return torch.gather(arr, 1, idx[:, None])[:, 0]


def _pick(cond, a, b, like):
    """where(cond, a, b) for Python-float a and b, in like's dtype."""
    return torch.where(cond, torch.full_like(like, a),
                       torch.full_like(like, b))


def lifted_parcel(T, q, qs, p, gz, nk, icb, nl0, params):
    """TLIFT (:50): temperature, virtual temperature and condensate of a
    parcel lifted from level nk; dry below cloud base icb, two Newton
    iterations of the saturated ascent above.  Returns (tp, tvp, clw)."""
    cpd, cpv, cl = params['cpd'], params['cpv'], params['cl']
    rv, rd, lv0 = params['rv'], params['rd'], params['lv0']
    cpvmcl = cl - cpv
    eps = rd / rv
    epsi = 1.0 / eps
    nz = T.shape[1]
    k = torch.arange(nz, device=T.device)[None, :]

    T_nk = _take_level(T, nk)
    q_nk = _take_level(q, nk)
    gz_nk = _take_level(gz, nk)

    ah0 = ((cpd * (1.0 - q_nk) + cl * q_nk) * T_nk
           + q_nk * (lv0 - cpvmcl * (T_nk - 273.15)) + gz_nk)
    cpp = cpd * (1.0 - q_nk) + q_nk * cpv
    tp_dry = T_nk[:, None] - (gz - gz_nk[:, None]) / cpp[:, None]
    tvp_dry = tp_dry * (1.0 + q_nk[:, None] * epsi)

    tg = T
    qg = qs
    alv = lv0 - cpvmcl * (T - 273.15)
    for _ in range(2):
        s = 1.0 / (cpd + alv * alv * qg / (rv * T * T))
        ahg = cpd * tg + (cl - cpd) * q_nk[:, None] * T + alv * qg + gz
        tg = torch.clamp(tg + s * (ah0[:, None] - ahg), min=35.0)
        tc = tg - 273.15
        es = torch.where(
            tc >= 0.0,
            6.112 * torch.exp(17.67 * tc / (243.5 + tc)),
            torch.exp(23.33086 - 6111.72784 / tg + 0.15215 * torch.log(tg)))
        qg = eps * es / torch.clamp(p - es * (1.0 - eps), min=1e-30)
    tp_sat = (ah0[:, None] - (cl - cpd) * q_nk[:, None] * T - gz
              - alv * qg) / cpd
    clw = torch.clamp(q_nk[:, None] - qg, min=0.0)
    rg = qg / (1.0 - q_nk[:, None])
    tvp_sat = tp_sat * (1.0 + rg * epsi)

    below_cb = k < icb[:, None]
    tp = torch.where(below_cb, tp_dry, tp_sat)
    tvp = torch.where(below_cb, tvp_dry, tvp_sat)
    clw = torch.where(below_cb, 0.0, clw)
    tvp = tvp - tp * q_nk[:, None]
    tvp = tvp.clone()
    tvp[:, nl0 + 1] = tvp[:, nl0] - (gz[:, nl0 + 1] - gz[:, nl0]) / cpd
    return tp, tvp, clw


def emanuel_convect(T, q, qs, u, v, p, ph, cbmf_in, dt, nl, params):
    """One call of the scheme over all columns (:125): the plain version
    for CPU tensors, the kernel (``emanuel_convect_cuda``) for CUDA
    tensors, which takes 4 to ``MAX_NZ`` levels, has no backward and
    refuses inputs that require grad.

    T, q, qs, u, v, p: (ncol, nz) bottom-up, p and ph (ncol, nz+1) in mb;
    cbmf_in (ncol,); nl the highest convecting level (Fortran count).
    Returns dict with ft, fq, fu, fv, precip, wd, tprime, qprime, cbmf,
    cape, iflag."""
    if T.device.type == 'cpu':
        return emanuel_convect_plain(T, q, qs, u, v, p, ph, cbmf_in, dt, nl,
                                     params)
    return emanuel_convect_cuda(T, q, qs, u, v, p, ph, cbmf_in, dt, nl,
                                params)


def emanuel_convect_cuda(T, q, qs, u, v, p, ph, cbmf_in, dt, nl, params):
    """Launch csrc/emanuel.cu once for all columns.  Arguments and outputs
    as ``emanuel_convect``; any strides (the moist GCM passes transposed
    (nz, ncol) fields); float32 or float64, all on one CUDA device.  The
    level outputs take T's layout."""
    args = (T, q, qs, u, v, p, ph, cbmf_in)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        raise NotImplementedError(
            'emanuel_convect_cuda has no backward: convection on the card '
            'cannot be differentiated; run it on the CPU')
    dtype = T.dtype
    if dtype not in (torch.float32, torch.float64) or any(
            a.dtype != dtype for a in args):
        raise TypeError('emanuel_convect_cuda takes float32 or float64 '
                        'tensors of one dtype, got %s' % sorted(
                            {str(a.dtype) for a in args}))
    if T.dim() != 2:
        raise ValueError('emanuel_convect_cuda: T must be (ncol, nz), got '
                         'shape %s' % (tuple(T.shape),))
    ncol, nz = T.shape
    if not 4 <= nz <= MAX_NZ:
        raise ValueError('emanuel_convect_cuda takes 4 to %d levels, got %d'
                         % (MAX_NZ, nz))
    if not 1 <= nl <= nz - 1:
        raise ValueError('emanuel_convect_cuda: nl=%s outside [1, %d]'
                         % (nl, nz - 1))
    for name, a, shape in (('q', q, (ncol, nz)), ('qs', qs, (ncol, nz)),
                           ('u', u, (ncol, nz)), ('v', v, (ncol, nz)),
                           ('p', p, (ncol, nz)), ('ph', ph, (ncol, nz + 1)),
                           ('cbmf_in', cbmf_in, (ncol,))):
        if tuple(a.shape) != shape:
            raise ValueError('emanuel_convect_cuda: %s has shape %s, '
                             'expected %s' % (name, tuple(a.shape), shape))
    dev = T.device
    if not all(a.is_cuda and a.device == dev for a in args):
        raise ValueError('emanuel_convect_cuda: all tensors must be on one '
                         'CUDA device')

    levels = [torch.empty_like(T) for _ in range(4)]      # ft, fq, fu, fv
    osc, osk = levels[0].stride()
    scalars = [torch.empty(ncol, dtype=dtype, device=dev) for _ in range(6)]
    iflag = torch.empty(ncol, dtype=torch.int64, device=dev)
    t = []
    for a in args[:7]:
        t += [a.data_ptr(), a.stride(0), a.stride(1)]
    t += [cbmf_in.data_ptr(), cbmf_in.stride(0)]
    t += [x.data_ptr() for x in levels] + [osc, osk]
    t += [x.data_ptr() for x in scalars] + [iflag.data_ptr()]
    t_arr = (ctypes.c_longlong * len(t))(*t)
    prm = (ctypes.c_double * (len(KERNEL_PARAMS) + 1))(
        *[float(params[key]) for key in KERNEL_PARAMS], float(dt))
    fn = getattr(_build.library(), 'climt_emanuel_f32' if dtype ==
                 torch.float32 else 'climt_emanuel_f64')
    rc = fn(ctypes.addressof(t_arr), ctypes.addressof(prm), ncol, nz,
            int(nl), int(params['minorig']),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, 'emanuel_convect_cuda')
    emanuel_convect_cuda.launches += 1
    out = dict(zip(('ft', 'fq', 'fu', 'fv'), levels))
    out.update(zip(('precip', 'wd', 'tprime', 'qprime', 'cbmf', 'cape'),
                   scalars))
    out['iflag'] = iflag
    return out


emanuel_convect_cuda.launches = 0


def emanuel_convect_plain(T, q, qs, u, v, p, ph, cbmf_in, dt, nl, params):
    """The plain PyTorch version of ``emanuel_convect``, the same
    arguments and outputs: the CPU path, and what the kernel is held to on
    the card."""
    T, q, qs, u, v, p, ph = [x.contiguous() for x in (T, q, qs, u, v, p,
                                                        ph)]
    ncol, nz = T.shape
    dev, dtype = T.device, T.dtype
    k = torch.arange(nz, device=dev)[None, :]
    cpd, cpv, cl = params['cpd'], params['cpv'], params['cl']
    rv, rd = params['rv'], params['rd']
    lv0, g, rowl = params['lv0'], params['g'], params['rowl']
    sigd, sigs = params['sigd'], params['sigs']
    entp = params['entp']
    elcrit, tlcrit = params['elcrit'], params['tlcrit']
    omtrain, omtsnow = params['omtrain'], params['omtsnow']
    coeffr, coeffs = params['coeffr'], params['coeffs']
    cu, beta = params['cu'], params['beta']
    dtmax = params['dtmax']
    alpha, damp, delt0 = params['alpha'], params['damp'], params['delt0']
    minorig = params['minorig']

    cpvmcl = cl - cpv
    eps = rd / rv
    epsi = 1.0 / eps
    ginv = 1.0 / g
    nl0 = nl - 1
    dph = ph[:, :-1] - ph[:, 1:]

    # ---- geopotential, heat capacity, static energies -----------------
    tv = T * (1.0 + q * epsi - q)
    gz_incr = torch.cat([
        torch.zeros_like(T[:, :1]),
        0.5 * rd * (tv[:, 1:] + tv[:, :-1]) * (p[:, :-1] - p[:, 1:])
        / ph[:, 1:-1]], dim=1)
    gz = torch.cumsum(gz_incr, dim=1)
    cpn = cpd * (1.0 - q) + cpv * q
    h = T * cpn + gz
    lv = lv0 - cpvmcl * (T - 273.15)
    hm = (cpd * (1.0 - q) + cl * q) * (T - T[:, :1]) + lv * q + gz
    hm = torch.cat([(lv[:, 0] * q[:, 0])[:, None], hm[:, 1:]], dim=1)
    lvcp = lv / cpn

    # ---- level of minimum moist static energy (sequential) ------------
    ahmin = torch.full((ncol,), 1e12, dtype=dtype, device=dev)
    ihmin = torch.full((ncol,), nl0, dtype=torch.int64, device=dev)
    for kk in range(1, nl0 + 2):
        take = ((hm[:, kk] < ahmin) & (hm[:, kk] < hm[:, kk - 1])
                & (kk >= max(minorig, 1)))
        ahmin = torch.where(take, hm[:, kk], ahmin)
        ihmin = torch.where(take, kk, ihmin)
    ihmin = torch.clamp(ihmin, max=nl0 - 1)

    # ---- parcel origin level nk: max hm in [minorig, ihmin] ------------
    in_range = (k >= minorig) & (k <= ihmin[:, None])
    hm_for_max = torch.where(in_range & (hm > 0.0), hm, -np.inf)
    nk = torch.argmax(hm_for_max, dim=1)
    any_pos = torch.any(hm_for_max > -np.inf, dim=1)
    nk = torch.where(any_pos, nk, 0)

    T_nk = _take_level(T, nk)
    q_nk = _take_level(q, nk)
    qs_nk = _take_level(qs, nk)
    p_nk = _take_level(p, nk)

    no_conv0 = (T_nk < 250.0) | (q_nk <= 0.0) | (ihmin == nl0 - 1)

    # ---- lifted condensation level -------------------------------------
    rh = q_nk / torch.clamp(qs_nk, min=1e-30)
    chi = T_nk / (1669.0 - 122.0 * rh - T_nk)
    plcl = p_nk * torch.clamp(rh, min=1e-30) ** chi
    no_conv2 = (plcl < 200.0) | (plcl >= 2000.0)

    # ---- first level fully above the LCL (cloud base icb) --------------
    above_lcl = (p < plcl[:, None]) & (k > nk[:, None]) & (k <= nl0)
    icb = torch.where(torch.any(above_lcl, dim=1),
                      torch.argmax(above_lcl.to(torch.uint8), dim=1),
                      nl0 - 1)
    icb = torch.clamp(icb, max=nl0 - 1)
    no_conv3 = icb >= (nl0 - 1)

    safe = ~(no_conv0 | no_conv2 | no_conv3)
    icb_s = torch.clamp(icb, 1, nz - 3)
    nk_s = torch.clamp(nk, 0, nz - 4)

    # ---- lifted parcel --------------------------------------------------
    tp, tvp, clw = lifted_parcel(T, q, qs, p, gz, nk, icb_s, nl0, params)

    tv_icb = _take_level(tv, icb_s)
    tvp_icb = _take_level(tvp, icb_s)
    stable_skip = (cbmf_in == 0.0) & (tvp_icb <= tv_icb - dtmax)

    # ---- precipitation efficiencies ------------------------------------
    tca = tp - 273.15
    elacrit = torch.where(tca >= 0.0, elcrit, elcrit * (1.0 - tca / tlcrit))
    elacrit = torch.clamp(elacrit, min=0.0)
    ep = _EPMAX * (1.0 - elacrit / torch.clamp(clw, min=1e-8))
    ep = torch.clamp(ep, 0.0, _EPMAX)
    ep = torch.where(k <= nk_s[:, None], 0.0, ep)
    sigp = torch.full_like(T, sigs)

    # ---- CAPE and top of convection (inb) ------------------------------
    by = (tvp - tv) * dph / p
    cape = torch.zeros(ncol, dtype=dtype, device=dev)
    capem = torch.zeros_like(cape)
    byp = torch.zeros_like(cape)
    inb = icb_s + 1
    inb1 = icb_s + 1
    for kk in range(nz - 1):
        active_k = (kk >= icb_s + 1) & (kk <= nl0 - 1)
        by_i = by[:, kk]
        cape = torch.where(active_k, cape + by_i, cape)
        inb1 = torch.where(active_k & (by_i >= 0.0), kk + 1, inb1)
        pos = active_k & (cape > 0.0)
        inb = torch.where(pos, kk + 1, inb)
        byp = torch.where(pos, by[:, kk + 1], byp)
        capem = torch.where(pos, cape, capem)
    inb = torch.maximum(inb, inb1)
    inb = torch.minimum(torch.maximum(inb, icb_s + 1),
                        torch.full_like(inb, nl0))
    cape = capem + byp
    defrac = torch.clamp(capem - cape, min=0.001)
    frac = torch.clamp(-cape / defrac, 0.0, 1.0)

    # ---- liquid water static energy of the lifted parcel ---------------
    in_cloud = (k >= icb_s[:, None]) & (k <= inb[:, None])
    hp = torch.where(in_cloud,
                     _take_level(h, nk_s)[:, None]
                     + (lv + (cpd - cpv) * T) * ep * clw, h)

    # ---- cloud base mass flux relaxation -------------------------------
    icbm1 = torch.clamp(icb_s - 1, 0, nz - 1)
    tvp_icbm1 = _take_level(tvp, icbm1)
    p_icbm1 = _take_level(p, icbm1)
    cpn_icbm1 = _take_level(cpn, icbm1)
    tvpplcl = tvp_icbm1 - rd * tvp_icbm1 * (p_icbm1 - plcl) / (
        cpn_icbm1 * p_icbm1)
    icbp1 = torch.clamp(icb_s + 1, 0, nz - 1)
    tvp_icbp1 = _take_level(tvp, icbp1)
    p_icb = _take_level(p, icb_s)
    p_icbp1 = _take_level(p, icbp1)
    tvaplcl = tv_icb + (tvp_icb - tvp_icbp1) * (plcl - p_icb) / (
        p_icb - p_icbp1)
    pbl_mask = (k >= nk_s[:, None]) & (k <= icbm1[:, None])
    dtpbl = torch.sum(torch.where(pbl_mask, (tvp - tv) * dph, 0.0), dim=1)
    ph_nk = _take_level(ph[:, :-1], nk_s)
    ph_icb = _take_level(ph[:, :-1], icb_s)
    dtpbl = dtpbl / torch.clamp(ph_nk - ph_icb, min=1e-10)
    dtma = tvpplcl - tvaplcl + dtmax + dtpbl

    damps = damp * dt / delt0
    cbmf = torch.clamp((1.0 - damps) * cbmf_in + 0.1 * alpha * dtma, min=0.0)
    zero_flux_skip = (cbmf == 0.0) & (cbmf_in == 0.0)
    active = safe & ~stable_skip & ~zero_flux_skip

    # ---- mixing rates m(i) ---------------------------------------------
    k_eff = torch.minimum(k, inb1[:, None])
    tv_eff = torch.gather(tv, 1, k_eff)
    tvp_eff = torch.gather(tvp, 1, k_eff)
    dph_eff = torch.gather(dph, 1, torch.clamp(k_eff, max=nz - 1))
    dbo = torch.abs(tv_eff - tvp_eff) + entp * 0.02 * dph_eff
    m_mask = (k >= icb_s[:, None] + 1) & (k <= inb[:, None])
    dbosum = torch.sum(torch.where(m_mask, dbo, 0.0), dim=1)
    m = torch.where(m_mask, cbmf[:, None] * dbo
                    / torch.clamp(dbosum, min=1e-30)[:, None], 0.0)

    # ---- buoyancy-sorted mixing matrix (i = origin row, j = mixing col)
    qti = q_nk[:, None] - ep * clw
    Tj = T[:, None, :]
    hi = h[:, :, None]
    hj = h[:, None, :]
    hpi = hp[:, :, None]
    qi = q[:, :, None]
    qj = q[:, None, :]
    qsj = qs[:, None, :]
    lvj = lv[:, None, :]
    clwj = clw[:, None, :]
    epj = ep[:, None, :]
    qti_i = qti[:, :, None]

    bf2 = 1.0 + lvj * lvj * qsj / (rv * Tj * Tj * cpd)
    anum = hj - hpi + (cpv - cpd) * Tj * (qti_i - qj)
    denom = hi - hpi + (cpd - cpv) * (qi - qti_i) * Tj
    dei = torch.where(torch.abs(denom) < 0.01, 0.01, denom)
    sij = anum / dei
    eye = torch.eye(nz, dtype=torch.bool, device=dev)[None]
    sij = torch.where(eye, 1.0, sij)
    altem = (sij * qi + (1.0 - sij) * qti_i - qsj) / bf2
    cwat = clwj * (1.0 - epj)
    ij_j = torch.arange(nz, device=dev)[None, None, :]
    ij_i = torch.arange(nz, device=dev)[None, :, None]
    need_alt = ((sij < 0.0) | (sij > 1.0) | (altem > cwat)) & (ij_j > ij_i)
    anum2 = anum - lvj * (qti_i - qsj - cwat * bf2)
    denom2 = denom + lvj * (qi - qti_i)
    denom2 = torch.where(torch.abs(denom2) < 0.01, 0.01, denom2)
    sij2 = anum2 / denom2
    altem2 = sij2 * qi + (1.0 - sij2) * qti_i - qsj - (bf2 - 1.0) * cwat
    sij = torch.where(need_alt, sij2, sij)
    altem = torch.where(need_alt, altem2, altem)

    kr = k[:, :, None]
    kc = k[:, None, :]
    valid_ij = ((kr >= icb_s[:, None, None] + 1)
                & (kr <= inb[:, None, None])
                & (kc >= icb_s[:, None, None])
                & (kc <= inb[:, None, None]))
    entrains = (sij > 0.0) & (sij < 0.9) & valid_ij
    shape3 = sij.shape
    qent = torch.where(entrains, sij * qi + (1.0 - sij) * qti_i,
                       qj.expand(shape3))
    u_i = u[:, :, None]
    v_i = v[:, :, None]
    u_nk = _take_level(u, nk_s)[:, None, None]
    v_nk = _take_level(v, nk_s)[:, None, None]
    uent = torch.where(entrains, sij * u_i + (1.0 - sij) * u_nk,
                       u[:, None, :].expand(shape3))
    vent = torch.where(entrains, sij * v_i + (1.0 - sij) * v_nk,
                       v[:, None, :].expand(shape3))
    elij = torch.where(entrains, torch.clamp(altem, min=0.0), 0.0)
    ment = torch.where(entrains,
                       m[:, :, None] / torch.clamp(1.0 - sij, min=1e-10), 0.0)
    nent = torch.sum(entrains, dim=2)
    sij_stored = torch.clamp(torch.where(valid_ij | eye, sij, 0.0), 0.0, 1.0)

    # detrain-at-level fallback when nothing entrains at level i
    no_ent = ((nent == 0) & m_mask)[:, :, None] & eye
    ment = torch.where(no_ent, m[:, :, None], ment)
    qent = torch.where(no_ent, qti[:, :, None], qent)
    uent = torch.where(no_ent, u_nk, uent)
    vent = torch.where(no_ent, v_nk, vent)
    elij = torch.where(no_ent, clw[:, :, None], elij)
    sij_stored = torch.where(no_ent, 1.0, sij_stored)

    # ---- normalize entrained fluxes (equal mixing probability) ---------
    anum_s = h - hp - lv * (qti - qs)
    denom_s = h - hp + lv * (q - qti)
    denom_s = torch.where(torch.abs(denom_s) < 0.01, 0.01, denom_s)
    scrit = anum_s / denom_s
    alt_s = qti - qs + scrit * (q - qti)
    scrit = torch.where(alt_s < 0.0, 1.0, scrit)
    scrit = torch.clamp(scrit, min=0.0)

    sij_jm1 = torch.nn.functional.pad(sij_stored, (1, 0))[:, :, :nz]
    sij_jp1 = torch.nn.functional.pad(sij_stored, (0, 1))[:, :, 1:]
    cond_ent = (sij_stored > 0.0) & (sij_stored < 0.9) & valid_ij

    # sequential running SMIN over j for the j > i branch
    weights = []
    smin = torch.ones((ncol, nz), dtype=dtype, device=dev)
    i_idx = torch.arange(nz, device=dev)[None, :]
    for j in range(nz):
        s_j = sij_stored[:, :, j]
        s_jp1 = sij_jp1[:, :, j]
        s_jm1 = sij_jm1[:, :, j]
        cond_j = cond_ent[:, :, j]
        is_above = j > i_idx
        smid_a = torch.minimum(s_j, scrit)
        take = cond_j & is_above & (smid_a < smin) & (s_jp1 < smid_a)
        sjmax_a = torch.where(
            take, torch.minimum(torch.minimum(s_jp1, s_j), scrit), smid_a)
        sjmin_a = torch.where(
            take, torch.minimum(torch.maximum(s_jm1, s_j), scrit), smid_a)
        smin = torch.where(take, smid_a, smin)
        sjmax_b = torch.maximum(s_jp1, scrit)
        smid_b = torch.maximum(s_j, scrit)
        sjmin_b = torch.maximum(s_jm1 if j > 0 else torch.zeros_like(s_jm1),
                                scrit)
        smid = torch.where(is_above, smid_a, smid_b)
        sjmax = torch.where(is_above, sjmax_a, sjmax_b)
        sjmin = torch.where(is_above, sjmin_a, sjmin_b)
        weights.append(torch.where(
            cond_j, torch.abs(sjmax - smid) + torch.abs(sjmin - smid), 0.0))
    weight = torch.stack(weights, dim=2)             # (ncol, nz_i, nz_j)
    dph_j = dph[:, None, :]
    ment_w = ment * weight * dph_j
    asij = torch.sum(weight * dph_j * cond_ent, dim=2)
    asij = torch.clamp(asij, min=1e-21)
    has_ent = nent > 0
    ment = torch.where(cond_ent & has_ent[:, :, None],
                       ment_w / asij[:, :, None], ment)
    bsum = torch.sum(torch.where(valid_ij, ment, 0.0), dim=2)
    resort = ((has_ent & (bsum < 1e-18) & m_mask)[:, :, None]) & eye
    ment = torch.where(resort, m[:, :, None], ment)
    qent = torch.where(resort, qti[:, :, None], qent)
    uent = torch.where(resort, u_nk, uent)
    vent = torch.where(resort, v_nk, vent)
    elij = torch.where(resort, clw[:, :, None], elij)

    # ---- precipitating downdraft (sequential descent) ------------------
    ep_inb = _take_level(ep, inb)
    skip_dd = ep_inb < 0.0001
    awat_ji = torch.clamp(elij - (1.0 - ep[:, None, :]) * clw[:, None, :],
                          min=0.0)
    lower_tri = ij_i < ij_j
    wdtrain_extra = torch.sum(
        torch.where(lower_tri, g * awat_ji * ment, 0.0), dim=1)
    wdtrain_all = g * ep * m * clw + wdtrain_extra

    warm = T > 273.0
    coeff_lvl = _pick(warm, coeffr, coeffs, T)
    wt = _pick(warm, omtrain, omtsnow, T)

    water = [None] * (nz + 1)
    evap_l = [None] * nz
    mp_l = [None] * (nz + 1)
    qp_l = [None] * (nz + 1)
    up_l = [None] * (nz + 1)
    vp_l = [None] * (nz + 1)
    wt_l = [None] * (nz + 1)
    zero = torch.zeros(ncol, dtype=dtype, device=dev)
    water[nz] = zero
    mp_l[nz] = zero
    wt_l[nz] = torch.full((ncol,), omtsnow, dtype=dtype, device=dev)
    qp_l[nz] = q[:, nz - 1]
    up_l[nz] = u[:, nz - 1]
    vp_l[nz] = v[:, nz - 1]
    jtt_p = p[:, 0] * 0 + 1.0
    jtt_mp = zero
    jtt_set = torch.zeros(ncol, dtype=torch.bool, device=dev)

    for i in range(nz - 1, -1, -1):
        in_dd = (i <= inb) & active & ~skip_dd
        wt_i = wt[:, i]
        coeff_i = coeff_lvl[:, i]
        qsm = 0.5 * (q[:, i] + qp_l[i + 1])
        afac = torch.clamp(
            coeff_i * ph[:, i] * (qs[:, i] - qsm)
            / (1.0e4 + 2.0e3 * ph[:, i] * qs[:, i]), min=0.0)
        sigt = torch.clamp(sigp[:, i], 0.0, 1.0)
        b6 = 100.0 * dph[:, i] * sigt * afac / wt_i
        c6 = (water[i + 1] * wt_l[i + 1] + wdtrain_all[:, i] / sigd) / wt_i
        revap = 0.5 * (-b6 + torch.sqrt(torch.clamp(b6 * b6 + 4.0 * c6,
                                                    min=0.0)))
        evap_i = torch.where(in_dd, sigt * afac * revap, 0.0)
        water_i = torch.where(in_dd, revap * revap, 0.0)

        if i > 0:
            dhdp = torch.clamp(
                (h[:, i] - h[:, i - 1])
                / torch.clamp(p[:, i - 1] - p[:, i], min=1e-10), min=10.0)
            mp_i = torch.clamp(
                100.0 * ginv * lv[:, i] * sigd * evap_i / dhdp, min=0.0)
            fac = 20.0 / torch.clamp(dph[:, i - 1], min=1e-10)
            mp_i = (fac * mp_l[i + 1] + mp_i) / (1.0 + fac)
            near_sfc = p[:, i] > 0.949 * p[:, 0]
            newly = near_sfc & ~jtt_set & in_dd
            jtt_p = torch.where(newly, p[:, i], jtt_p)
            jtt_mp = torch.where(newly, mp_i, jtt_mp)
            jtt_set = jtt_set | newly
            mp_i = torch.where(near_sfc & jtt_set,
                               jtt_mp * (p[:, 0] - p[:, i])
                               / torch.clamp(p[:, 0] - jtt_p, min=1e-10),
                               mp_i)
            mp_i = torch.where(in_dd, mp_i, 0.0)
        else:
            mp_i = zero
        mp_l[i] = mp_i

        is_inb = inb == i
        qstm = qs[:, max(i - 1, 0)]
        grow = mp_i > mp_l[i + 1]
        rat = mp_l[i + 1] / torch.clamp(mp_i, min=1e-30)
        qp_grow = (qp_l[i + 1] * rat + q[:, i] * (1.0 - rat)
                   + 100.0 * ginv * sigd * dph[:, i]
                   * (evap_i / torch.clamp(mp_i, min=1e-30)))
        up_grow = up_l[i + 1] * rat + u[:, i] * (1.0 - rat)
        vp_grow = vp_l[i + 1] * rat + v[:, i] * (1.0 - rat)
        ip1 = min(i + 1, nz - 1)
        qp_desc = ((gz[:, ip1] - gz[:, i]
                    + qp_l[i + 1] * (lv[:, ip1] + T[:, ip1] * (cl - cpd))
                    + cpd * (T[:, ip1] - T[:, i]))
                   / (lv[:, i] + T[:, i] * (cl - cpd)))
        has_mp_up = mp_l[i + 1] > 0.0
        im1 = max(i - 1, 0)
        qp_i = torch.where(grow, qp_grow,
                           torch.where(has_mp_up, qp_desc, q[:, im1]))
        up_i = torch.where(grow, up_grow,
                           torch.where(has_mp_up, up_l[i + 1], u[:, im1]))
        vp_i = torch.where(grow, vp_grow,
                           torch.where(has_mp_up, vp_l[i + 1], v[:, im1]))
        qp_i = torch.minimum(torch.clamp(qp_i, min=0.0), qstm)
        upd = in_dd & ~is_inb          # at i == inb the update is skipped
        qp_l[i] = torch.where(upd, qp_i, q[:, im1])
        up_l[i] = torch.where(upd, up_i, u[:, im1])
        vp_l[i] = torch.where(upd, vp_i, v[:, im1])
        water[i] = water_i
        evap_l[i] = evap_i
        wt_l[i] = wt_i

    water_arr = torch.stack(water[:nz], dim=1)
    evap_arr = torch.stack(evap_l, dim=1)
    mp_arr = torch.stack(mp_l, dim=1)
    qp_arr = torch.stack(qp_l, dim=1)
    up_arr = torch.stack(up_l, dim=1)
    vp_arr = torch.stack(vp_l, dim=1)
    wt_arr = torch.stack(wt_l, dim=1)

    precip = torch.where(
        active & ~skip_dd,
        wt_arr[:, 0] * sigd * water_arr[:, 0] * 3600.0 * 24000.0
        / (rowl * g), 0.0)

    # ---- downdraft scales ----------------------------------------------
    mp_icb = _take_level(mp_arr[:, :nz], icb_s)
    T_icb = _take_level(T, icb_s)
    wd = beta * torch.abs(mp_icb) * 0.01 * rd * T_icb / (sigd * p_icb)
    qprime = 0.5 * (qp_arr[:, 0] - q[:, 0])
    tprime = lv0 * qprime / cpd

    # ---- tendencies ----------------------------------------------------
    delti = 1.0 / dt
    iflag = torch.where(active, 1, 0)

    dpinv0 = 0.01 / dph[:, 0]
    am_mask = (k >= 1) & (k <= inb[:, None])
    am = torch.where(nk_s == 0,
                     torch.sum(torch.where(am_mask, m, 0.0), dim=1), 0.0)
    cfl1 = (2.0 * g * dpinv0 * am) >= delti
    ft0 = (g * dpinv0 * am * (T[:, 1] - T[:, 0]
                              + (gz[:, 1] - gz[:, 0]) / cpn[:, 0])
           - lvcp[:, 0] * sigd * evap_arr[:, 0]
           + sigd * wt_arr[:, 1] * (cl - cpd) * water_arr[:, 1]
           * (T[:, 1] - T[:, 0]) * dpinv0 / cpn[:, 0])
    fq0 = (g * mp_arr[:, 1] * (qp_arr[:, 1] - q[:, 0]) * dpinv0
           + sigd * evap_arr[:, 0]
           + g * am * (q[:, 1] - q[:, 0]) * dpinv0)
    fu0 = g * dpinv0 * (mp_arr[:, 1] * (up_arr[:, 1] - u[:, 0])
                        + am * (u[:, 1] - u[:, 0]))
    fv0 = g * dpinv0 * (mp_arr[:, 1] * (vp_arr[:, 1] - v[:, 0])
                        + am * (v[:, 1] - v[:, 0]))
    ment_j0 = ment[:, :, 0]
    fq0 = fq0 + g * dpinv0 * torch.sum(
        torch.where(am_mask, ment_j0 * (qent[:, :, 0] - q[:, 0:1]), 0.0),
        dim=1)
    fu0 = fu0 + g * dpinv0 * torch.sum(
        torch.where(am_mask, ment_j0 * (uent[:, :, 0] - u[:, 0:1]), 0.0),
        dim=1)
    fv0 = fv0 + g * dpinv0 * torch.sum(
        torch.where(am_mask, ment_j0 * (vent[:, :, 0] - v[:, 0:1]), 0.0),
        dim=1)

    dpinv = 0.01 / dph
    cpinv = 1.0 / cpn
    inb_p1 = torch.clamp(inb + 1, max=nz - 1)
    m_cum_rev = torch.flip(torch.cumsum(torch.flip(m, [1]), dim=1), [1])
    m_above = torch.cat([m_cum_rev[:, 1:], torch.zeros_like(m[:, :1])],
                        dim=1)
    amp1_m = torch.where(k >= nk_s[:, None], m_above, 0.0)
    jj_ = np.arange(nz)
    ment_cols = torch.where(kc <= inb_p1[:, None, None], ment, 0.0)
    W_amp = ((jj_[:, None, None] <= jj_[None, None, :])
             & (jj_[None, :, None] > jj_[None, None, :]))
    W_amp = torch.as_tensor(W_amp.reshape(nz * nz, nz), dtype=dtype,
                            device=dev)
    amp1 = amp1_m + ment_cols.reshape(ncol, nz * nz) @ W_amp

    ment_rows = torch.where(kr <= inb[:, None, None], ment, 0.0)
    W_ad = ((jj_[:, None, None] >= jj_[None, None, :])
            & (jj_[None, :, None] < jj_[None, None, :]))
    W_ad = torch.as_tensor(W_ad.reshape(nz * nz, nz), dtype=dtype,
                           device=dev)
    ad = ment_rows.reshape(ncol, nz * nz) @ W_ad

    cfl = (2.0 * g * dpinv * amp1) >= delti

    def up1(x):
        return torch.cat([x[:, 1:], x[:, -1:]], dim=1)

    def dn1(x):
        return torch.cat([x[:, :1], x[:, :-1]], dim=1)

    T_up, T_dn = up1(T), dn1(T)
    q_up, q_dn = up1(q), dn1(q)
    u_up, u_dn = up1(u), dn1(u)
    v_up, v_dn = up1(v), dn1(v)
    gz_up, gz_dn = up1(gz), dn1(gz)

    ment_diag = torch.diagonal(ment, dim1=1, dim2=2)
    qent_diag = torch.diagonal(qent, dim1=1, dim2=2)
    water_up_arr = torch.cat([water_arr[:, 1:],
                              torch.zeros_like(water_arr[:, :1])], dim=1)
    wt_up_arr = wt_arr[:, 1:]
    mp_up_arr = mp_arr[:, 1:]
    qp_up_arr = qp_arr[:, 1:]
    up_up_arr = up_arr[:, 1:]
    vp_up_arr = vp_arr[:, 1:]
    mp_here = mp_arr[:, :nz]
    qp_here = qp_arr[:, :nz]
    up_here = up_arr[:, :nz]
    vp_here = vp_arr[:, :nz]

    ft = (g * dpinv * (amp1 * (T_up - T + (gz_up - gz) * cpinv)
                       - ad * (T - T_dn + (gz - gz_dn) * cpinv))
          - sigd * lvcp * evap_arr
          + g * dpinv * ment_diag * (hp - h + T * (cpv - cpd)
                                     * (q - qent_diag)) * cpinv
          + sigd * wt_up_arr * (cl - cpd) * water_up_arr
          * (T_up - T) * dpinv * cpinv)
    fq = g * dpinv * (amp1 * (q_up - q) - ad * (q - q_dn))
    fu = g * dpinv * (amp1 * (u_up - u) - ad * (u - u_dn))
    fv = g * dpinv * (amp1 * (v_up - v) - ad * (v - v_dn))

    awat_col = torch.clamp(
        elij - (1.0 - ep[:, None, :]) * clw[:, None, :], min=0.0)
    jlt = torch.as_tensor(np.arange(nz)[:, None] < np.arange(nz)[None, :],
                          dtype=dtype, device=dev)
    fq = fq + g * dpinv * (
        torch.sum(ment * (qent - q[:, None, :]), dim=1)
        - torch.einsum('cki,ki->ci', ment * awat_col, jlt))
    fu = fu + g * dpinv * torch.sum(ment * (uent - u[:, None, :]), dim=1)
    fv = fv + g * dpinv * torch.sum(ment * (vent - v[:, None, :]), dim=1)

    fq = fq + sigd * evap_arr + g * dpinv * (
        mp_up_arr * (qp_up_arr - q) - mp_here * (qp_here - q_dn))
    fu = fu + g * dpinv * (mp_up_arr * (up_up_arr - u)
                           - mp_here * (up_here - u_dn))
    fv = fv + g * dpinv * (mp_up_arr * (vp_up_arr - v)
                           - mp_here * (vp_here - v_dn))

    def set_lowest(f, f0):
        return torch.cat([f0[:, None], f[:, 1:]], dim=1)

    ft = set_lowest(ft, ft0)
    fq = set_lowest(fq, fq0)
    fu = set_lowest(fu, fu0)
    fv = set_lowest(fv, fv0)

    lev_mask = k <= inb[:, None]
    ft = torch.where(lev_mask, ft, 0.0)
    fq = torch.where(lev_mask, fq, 0.0)
    fu = torch.where(lev_mask, fu, 0.0)
    fv = torch.where(lev_mask, fv, 0.0)

    # ---- spread tendencies at the convection top by frac ---------------
    one_hot_inb = (k == inb[:, None]).to(dtype)
    one_hot_inbm1 = (k == (inb - 1)[:, None]).to(dtype)
    inbm1 = torch.clamp(inb - 1, min=0)
    ratio = _take_level(dph, inb) / torch.clamp(_take_level(dph, inbm1),
                                                 min=1e-10)

    def spread(f, extra_ratio):
        f_inb = torch.sum(f * one_hot_inb, dim=1)
        shift = frac * f_inb * ratio * extra_ratio
        return (f * (1.0 - frac[:, None] * one_hot_inb)
                + shift[:, None] * one_hot_inbm1)

    fq = spread(fq, _take_level(lv, inb) / _take_level(lv, inbm1))
    ft = spread(ft, _take_level(cpn, inb) / _take_level(cpn, inbm1))
    fu = spread(fu, torch.ones_like(frac))
    fv = spread(fv, torch.ones_like(frac))

    # ---- exact enthalpy / momentum conservation fix ---------------------
    cons_mask = (k <= inb[:, None]).to(dtype)
    ph_inb1 = _take_level(ph, inb + 1)
    norm = 1.0 / torch.clamp(ph[:, 0] - ph_inb1, min=1e-10)
    ents = torch.sum((cpn * ft + lv * fq) * dph * cons_mask, dim=1) * norm
    uav = torch.sum(fu * dph * cons_mask, dim=1) * norm
    vav = torch.sum(fv * dph * cons_mask, dim=1) * norm
    ft = ft - cons_mask * ents[:, None] / cpn
    fu = (1.0 - cu) * (fu - uav[:, None]) * cons_mask \
        + fu * (1.0 - cons_mask)
    fv = (1.0 - cu) * (fv - vav[:, None]) * cons_mask \
        + fv * (1.0 - cons_mask)

    # ---- final masking for inactive columns -----------------------------
    act = active[:, None]
    dd = active & ~skip_dd
    any_cfl = torch.any(torch.where(lev_mask, cfl, False), dim=1) | cfl1
    return {
        'ft': torch.where(act, ft, 0.0),
        'fq': torch.where(act, fq, 0.0),
        'fu': torch.where(act, fu, 0.0),
        'fv': torch.where(act, fv, 0.0),
        'precip': torch.where(active, precip, 0.0),
        'wd': torch.where(dd, wd, 0.0),
        'tprime': torch.where(dd, tprime, 0.0),
        'qprime': torch.where(dd, qprime, 0.0),
        'cbmf': torch.where(no_conv0 | no_conv2 | no_conv3, 0.0,
                            torch.where(stable_skip, cbmf_in, cbmf)),
        'cape': torch.where(active, cape, 0.0),
        'iflag': torch.where(active & any_cfl, 4, iflag),
    }


class EmanuelConvection(ImplicitTendencyComponent):
    """Emanuel & Zivkovic-Rothman (1999) convection scheme (:796), on
    ``device`` (the CUDA card unless the caller asks for another).

    On a card the scheme runs as one CUDA kernel (``emanuel_convect``),
    which takes 4 to 32 levels (``MAX_NZ``) and raises ``ValueError`` for
    more; on the CPU any level count runs."""

    input_properties = {
        'air_temperature': {'dims': ['*', 'mid_levels'], 'units': 'degK'},
        'specific_humidity': {'dims': ['*', 'mid_levels'],
                              'units': 'kg/kg'},
        'eastward_wind': {'dims': ['*', 'mid_levels'], 'units': 'm s^-1'},
        'northward_wind': {'dims': ['*', 'mid_levels'],
                           'units': 'm s^-1'},
        'air_pressure': {'dims': ['*', 'mid_levels'], 'units': 'mbar'},
        'air_pressure_on_interface_levels': {
            'dims': ['*', 'interface_levels'], 'units': 'mbar'},
        'cloud_base_mass_flux': {'dims': ['*'], 'units': 'kg m^-2 s^-1'},
    }

    diagnostic_properties = {
        'convective_state': {'dims': ['*'], 'units': 'dimensionless'},
        'convective_precipitation_rate': {'dims': ['*'],
                                          'units': 'mm day^-1'},
        'convective_downdraft_velocity_scale': {'dims': ['*'],
                                                'units': 'm s^-1'},
        'convective_downdraft_temperature_scale': {'dims': ['*'],
                                                   'units': 'degK'},
        'convective_downdraft_specific_humidity_scale': {
            'dims': ['*'], 'units': 'kg/kg'},
        'cloud_base_mass_flux': {'dims': ['*'], 'units': 'kg m^-2 s^-1'},
        'atmosphere_convective_available_potential_energy': {
            'dims': ['*'], 'units': 'J kg^-1'},
        'air_temperature_tendency_from_convection': {
            'dims': ['*', 'mid_levels'], 'units': 'degK day^-1'},
    }

    tendency_properties = {
        'air_temperature': {'units': 'degK s^-1'},
        'specific_humidity': {'units': 'kg/kg s^-1'},
        'eastward_wind': {'units': 'm s^-2'},
        'northward_wind': {'units': 'm s^-2'},
    }

    def __init__(self,
                 minimum_convecting_layer=1,
                 autoconversion_water_content_threshold=0.0011,
                 autoconversion_temperature_threshold=-55,
                 entrainment_mixing_coefficient=1.5,
                 downdraft_area_fraction=0.05,
                 precipitation_fraction_outside_cloud=0.12,
                 speed_water_droplets=50.0,
                 speed_snow=5.5,
                 rain_evaporation_coefficient=1.0,
                 snow_evaporation_coefficient=0.8,
                 convective_momentum_transfer_coefficient=0.7,
                 downdraft_surface_velocity_coefficient=10.0,
                 convection_bouyancy_threshold=0.9,
                 mass_flux_relaxation_rate=0.1,
                 mass_flux_damping_rate=0.1,
                 reference_mass_flux_timescale=300.,
                 device='cuda',
                 **kwargs):
        if not 0 <= convective_momentum_transfer_coefficient <= 1:
            raise ValueError(
                'Momentum transfer coefficient must be between 0 and 1.')
        if not 0 <= downdraft_area_fraction <= 1:
            raise ValueError(
                'Downdraft fraction must be between 0 and 1.')
        if not 0 <= precipitation_fraction_outside_cloud <= 1:
            raise ValueError(
                'Outside cloud precipitation fraction must be between '
                '0 and 1.')
        self.device = resolve_device(device)
        self._options = dict(
            minorig=minimum_convecting_layer - 1,
            elcrit=autoconversion_water_content_threshold,
            tlcrit=autoconversion_temperature_threshold,
            entp=entrainment_mixing_coefficient,
            sigd=downdraft_area_fraction,
            sigs=precipitation_fraction_outside_cloud,
            omtrain=speed_water_droplets,
            omtsnow=speed_snow,
            coeffr=rain_evaporation_coefficient,
            coeffs=snow_evaporation_coefficient,
            cu=convective_momentum_transfer_coefficient,
            beta=downdraft_surface_velocity_coefficient,
            dtmax=convection_bouyancy_threshold,
            alpha=mass_flux_relaxation_rate,
            damp=mass_flux_damping_rate,
            delt0=reference_mass_flux_timescale,
        )
        super().__init__(**kwargs)

    def array_call(self, raw_state, timestep):
        params = dict(self._options)
        for key, name, units in (
                ('g', 'gravitational_acceleration', 'm/s^2'),
                ('cpd', 'heat_capacity_of_dry_air_at_constant_pressure',
                 'J/kg/degK'),
                ('cpv', 'heat_capacity_of_vapor_phase', 'J/kg/degK'),
                ('rd', 'gas_constant_of_dry_air', 'J/kg/degK'),
                ('rv', 'gas_constant_of_vapor_phase', 'J/kg/degK'),
                ('lv0', 'latent_heat_of_condensation', 'J/kg'),
                ('rowl', 'density_of_liquid_phase', 'kg/m^3'),
                ('cl', 'specific_enthalpy_of_vapor_phase', 'J/kg')):
            params[key] = get_constant(name, units)
        T, q, u, v, p, ph, cbmf = (
            as_tensor(raw_state[name], self.device) for name in (
                'air_temperature', 'specific_humidity', 'eastward_wind',
                'northward_wind', 'air_pressure',
                'air_pressure_on_interface_levels', 'cloud_base_mass_flux'))
        # the reference passes (Cpd, Cpv) where bolton_q_sat takes the gas
        # constants (:910-912); kept for parity
        q_sat = bolton_q_sat(T, p * 100.0, params['cpd'], params['cpv'])
        out = emanuel_convect(T, q, q_sat, u, v, p, ph, cbmf,
                              timestep_seconds(timestep), T.shape[1] - 3,
                              params)
        tendencies = {
            'air_temperature': out['ft'],
            'specific_humidity': out['fq'],
            'eastward_wind': out['fu'],
            'northward_wind': out['fv'],
        }
        diagnostics = {
            'convective_state': out['iflag'].to(T.dtype),
            'convective_precipitation_rate': out['precip'],
            'convective_downdraft_velocity_scale': out['wd'],
            'convective_downdraft_temperature_scale': out['tprime'],
            'convective_downdraft_specific_humidity_scale': out['qprime'],
            'cloud_base_mass_flux': out['cbmf'],
            'atmosphere_convective_available_potential_energy':
                out['cape'],
            'air_temperature_tendency_from_convection':
                out['ft'] * 86400.0,
        }
        return tendencies, diagnostics


class EmanuelConvectionPython(EmanuelConvection):
    """The reference's name for its pure-Python Emanuel backend (:939):
    the same component under both names."""
