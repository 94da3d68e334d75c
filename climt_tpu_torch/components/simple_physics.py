"""Reed-Jablonowski (2012) simple physics on tensors
(climt_tpu/components/simple_physics.py).

Large-scale condensation, bulk surface fluxes with the Smith-Vogl drag
law, and the partially implicit boundary-layer diffusion whose
tridiagonal solve is an upward elimination plus a downward
back-substitution (Python loops over levels here, ``lax.scan`` there).
Level index 0 is the lowest layer; arrays are (nz, ncol).
"""

from __future__ import annotations

import torch


def _large_scale_condensation(T, q, p_mid, dp, dt, consts):
    """Saturation adjustment with latent-heat feedback (:33)."""
    eps, e0, T0 = consts['eps'], 610.78, 273.16
    lv, cp, rd, rv = consts['lv'], consts['cp'], consts['rd'], consts['rv']
    qsat = eps * e0 / p_mid * torch.exp(-lv / rv * (1.0 / T - 1.0 / T0))
    tmp = torch.where(
        q > qsat,
        (1.0 / dt) * (q - qsat)
        / (1.0 + (lv / cp) * (eps * lv * qsat / (rd * T ** 2))),
        0.0)
    new_T = T + (lv / cp) * tmp * dt
    new_q = q - tmp * dt
    precipitation = torch.sum(
        tmp * dp / (consts['g'] * consts['rhow']), dim=0)
    return new_T, new_q, precipitation


def _surface_fluxes(T, q, u, v, p_mid, p_int, ps, Ts, qsurf, za, dt,
                    consts, use_qsurf_ext):
    """Implicit surface drag, explicit sensible/latent heating of the
    lowest layer (:49)."""
    c_heat = consts['C']
    wind = torch.sqrt(u[0] ** 2 + v[0] ** 2)
    cd = torch.where(wind < 20.0, consts['Cd0'] + consts['Cd1'] * wind,
                     consts['Cm'])
    drag = 1.0 + cd * wind * dt / za
    u = torch.cat([(u[0] / drag)[None], u[1:]], dim=0)
    v = torch.cat([(v[0] / drag)[None], v[1:]], dim=0)

    dp_low = p_int[0] - p_int[1]
    rho = p_mid[0] / (consts['rd'] * T[0])
    t_flux = c_heat * wind * (Ts - T[0])
    sensible = rho * consts['cp'] * t_flux
    T = torch.cat([(T[0] + t_flux * (rho * consts['g']) / dp_low * dt)[None],
                   T[1:]], dim=0)

    es_warm = (1.0007 + 3.46e-8 * ps) * 611.21 * torch.exp(
        17.966 * (Ts - 273.) / (247.15 + (Ts - 273.)))
    es_cold = (1.0003 + 4.18e-8 * ps) * 611.15 * torch.exp(
        22.452 * (Ts - 273.) / (272.5 + (Ts - 273.)))
    es = torch.where(Ts > 271.0, es_warm, es_cold)
    qsats = consts['eps'] * es / (ps - 0.378 * es)
    if use_qsurf_ext:
        qsats = qsurf

    rho = p_mid[0] / (consts['rd'] * T[0])
    q_flux = c_heat * wind * (qsats - q[0])
    latent = consts['lv'] * rho * q_flux
    q = torch.cat([(q[0] + q_flux * (rho * consts['g']) / dp_low * dt)[None],
                   q[1:]], dim=0)
    return T, q, u, v, sensible, latent, wind, cd


def _pbl_diffusion(T, q, u, v, p_mid, p_int, dp, za, wind, cd, dt, consts):
    """Implicit vertical diffusion (:90): upward elimination, downward
    back-substitution, one loop each over the levels."""
    nz = T.shape[0]
    kappa = consts['rd'] / consts['cp']
    p0 = 1e5
    ke_surf = consts['C'] * wind * za
    km_surf = cd * wind * za

    p_i = p_int[1:-1]
    taper = torch.where(
        p_i >= consts['pbltop'], 1.0,
        torch.exp(-((consts['pbltop'] - p_i) / consts['pblconst']) ** 2))
    km = km_surf[None, :] * taper
    ke = ke_surf[None, :] * taper
    rho_i = p_i / (consts['rd'] * 0.5 * (T[1:] + T[:-1]))
    g2dt = dt * consts['g'] ** 2
    dpm = p_mid[:-1] - p_mid[1:]

    zero_row = torch.zeros_like(T[:1])
    ca_m = torch.cat([zero_row, g2dt * km * rho_i ** 2 / (dpm * dp[1:])])
    cc_m = torch.cat([g2dt * km * rho_i ** 2 / (dpm * dp[:-1]), zero_row])
    ca_e = torch.cat([zero_row, g2dt * ke * rho_i ** 2 / (dpm * dp[1:])])
    cc_e = torch.cat([g2dt * ke * rho_i ** 2 / (dpm * dp[:-1]), zero_row])

    theta = T * (p0 / p_mid) ** kappa

    zero = torch.zeros_like(wind)
    e_m_b = e_e_b = fu_b = fv_b = ft_b = fq_b = zero
    e_m, e_e, fu, fv, ft, fq = [], [], [], [], [], []
    for j in range(nz):
        denom_m = 1.0 + ca_m[j] + cc_m[j] - ca_m[j] * e_m_b
        denom_e = 1.0 + ca_e[j] + cc_e[j] - ca_e[j] * e_e_b
        e_m_b = cc_m[j] / denom_m
        e_e_b = cc_e[j] / denom_e
        fu_b = (u[j] + ca_m[j] * fu_b) / denom_m
        fv_b = (v[j] + ca_m[j] * fv_b) / denom_m
        ft_b = (theta[j] + ca_e[j] * ft_b) / denom_e
        fq_b = (q[j] + ca_e[j] * fq_b) / denom_e
        for lst, val in ((e_m, e_m_b), (e_e, e_e_b), (fu, fu_b),
                         (fv, fv_b), (ft, ft_b), (fq, fq_b)):
            lst.append(val)

    u_a = v_a = th_a = q_a = zero
    u_new, v_new, th_new, q_new = [None] * nz, [None] * nz, [None] * nz, \
        [None] * nz
    for j in range(nz - 1, -1, -1):
        u_a = e_m[j] * u_a + fu[j]
        v_a = e_m[j] * v_a + fv[j]
        th_a = e_e[j] * th_a + ft[j]
        q_a = e_e[j] * q_a + fq[j]
        u_new[j], v_new[j], th_new[j], q_new[j] = u_a, v_a, th_a, q_a

    T_new = torch.stack(th_new) * (p_mid / p0) ** kappa
    return T_new, torch.stack(q_new), torch.stack(u_new), torch.stack(v_new)


def simple_physics_step(T, q, u, v, p_mid, p_int, ps, Ts, qsurf, dt,
                        g, cp, rd, rv, lv, rhow, pbltop, pblconst,
                        c_heat, cd0, cd1, cm,
                        do_lsc, do_pbl, do_surf_flux, use_qsurf_ext):
    """One time-split simple-physics step (:167).  Returns
    (T, q, u, v, precipitation, sensible, latent)."""
    consts = dict(g=g, cp=cp, rd=rd, rv=rv, lv=lv, rhow=rhow,
                  eps=rd / rv, C=c_heat, Cd0=cd0, Cd1=cd1, Cm=cm,
                  pbltop=pbltop, pblconst=pblconst)
    zvir = rv / rd - 1.0
    dp = p_int[:-1] - p_int[1:]
    za = (rd / g) * T[0] * (1.0 + zvir * q[0]) * 0.5 * (
        torch.log(ps) - torch.log(p_int[1]))

    precipitation = torch.zeros_like(ps)
    if do_lsc:
        T, q, precipitation = _large_scale_condensation(
            T, q, p_mid, dp, dt, consts)

    sensible = torch.zeros_like(ps)
    latent = torch.zeros_like(ps)
    wind = torch.sqrt(u[0] ** 2 + v[0] ** 2)
    cd = torch.where(wind < 20.0, cd0 + cd1 * wind, cm)
    if do_surf_flux:
        T, q, u, v, sensible, latent, wind, cd = _surface_fluxes(
            T, q, u, v, p_mid, p_int, ps, Ts, qsurf, za, dt, consts,
            use_qsurf_ext)
    if do_pbl:
        T, q, u, v = _pbl_diffusion(
            T, q, u, v, p_mid, p_int, dp, za, wind, cd, dt, consts)
    return T, q, u, v, precipitation, sensible, latent

