"""The Held-Suarez GCM as one model step (climt_tpu/dycore/compiled.py).

Dynamics and physics together, with the marshalling done once at build
time: the physics is evaluated inside the dycore step from its
synthesized grid fields.  Where the JAX model scans a jitted step, this
one runs eagerly, and ``run_fn`` is a Python loop over ``step_fn``.
A carry placed by ``parallel.shard_model_state`` is stepped on its
blocks by a rank-local twin of the dycore on ``parallel.ReplicatedSHT``,
as ``MoistGCM`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..components.held_suarez import _held_suarez_tendencies
from ..core.grid import hybrid_sigma_pressure_coefficients
from ..core.util import resolve_device
from ..parallel.mesh import carry_layout, unwrap_carry, wrap_carry
from .spectral_dynamics import SpectralDycore


def held_suarez_physics_fn(dycore, sigma_b=0.7, k_f=1.0 / 86400.0,
                           k_a=1.0 / 40.0 / 86400.0,
                           k_s=1.0 / 4.0 / 86400.0,
                           delta_T_y=60.0, delta_theta_z=10.0, p0=1e5):
    """Held-Suarez forcing as a function of the dycore's grid-state dict
    (top-down (nz, nlat, nlon) fields, or the dycore's block of them), on
    the dycore's device and dtype (compiled.py:21)."""
    lat_rad = np.arcsin(dycore.sht.mu[dycore.sht.rows])
    like = dycore.coslat
    coslat2 = torch.as_tensor(np.cos(lat_rad) ** 2, dtype=like.dtype,
                              device=like.device)[None, :, None]
    sinlat2 = torch.as_tensor(np.sin(lat_rad) ** 2, dtype=like.dtype,
                              device=like.device)[None, :, None]

    def physics(gs):
        p = 0.5 * (gs['p_half'][1:] + gs['p_half'][:-1])
        du, dv, dT = _held_suarez_tendencies(
            gs['u'], gs['v'], gs['T'], p, gs['ps'][None], sinlat2, coslat2,
            sigma_b, k_f, k_a, k_s, delta_T_y, delta_theta_z, p0,
            dycore.kappa)
        return {'du': du, 'dv': dv, 'dT': dT,
                'dq': torch.zeros_like(gs['q'])}

    return physics


def build_held_suarez_model(nlon=128, nlat=64, nz=28, timestep=600.0,
                            number_of_damped_levels=5,
                            dtype=torch.float32, device='cuda'):
    """Return (dycore, init_fn, step_fn, run_fn) for the Held-Suarez GCM
    (compiled.py:55), on ``device``: the CUDA card unless the caller asks
    for another (``device='cpu'``); without a card the default raises.

    The carry is (prev, now, prev_grids): the spectral states at t-dt and
    t and the grid fields of ``prev``, on which the physics is lagged.
    ``init_fn(seed)`` draws the initial state with numpy exactly as the
    JAX model does; ``step_fn(carry, _)`` returns (carry, None);
    ``run_fn(carry, n_steps)`` returns the carry after n_steps.  Both
    also take a carry of ``parallel.shard_model_state(mesh, *init_fn(),
    shard_lon=...)`` and return one in its layout."""
    device = resolve_device(device)
    ak, bk = hybrid_sigma_pressure_coefficients(nz + 1, 1e5, 20.0)

    def make_dycore(**layout):
        return SpectralDycore(
            nlon, nlat, nz, ak, bk, timestep=timestep,
            number_of_damped_levels=number_of_damped_levels, dtype=dtype,
            device=device, **layout)

    dycore = make_dycore()
    physics = held_suarez_physics_fn(dycore)
    twins = {}

    def twin_of(carry):
        """(dycore, physics, mesh, shard_lon) of a placed carry's layout,
        built at its first carry and kept."""
        mesh, shard_lon = carry_layout(carry)
        key = (id(mesh), shard_lon)
        if key not in twins:
            d = make_dycore(mesh=mesh, layout='replicated',
                            shard_lon=shard_lon)
            twins[key] = (d, held_suarez_physics_fn(d), mesh, shard_lon)
        sht = twins[key][0].sht
        twins[key][0].phi_s = dycore.phi_s[sht.rows, sht.cols]
        return twins[key]

    def init_fn(seed=0):
        rng = np.random.RandomState(seed)
        shape = (nz, nlat, nlon)
        T = 290.0 + 0.1 * rng.randn(*shape)
        zeros = np.zeros(shape)
        lnps = np.full((nlat, nlon), np.log(1e5))

        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        spec = dycore.spectral_state_from_grid(t(zeros), t(zeros), t(T),
                                               t(zeros), t(lnps))
        prev, now = dycore.initial_step(spec, physics_fn=physics)
        return prev, now, dycore.grids_of(prev)

    def local_step(carry, dyc=dycore, phys=physics):
        prev, now, prev_grids = carry
        filtered, new, now_grids = dyc.step(prev, now, physics_fn=phys,
                                            prev_grids=prev_grids)
        return filtered, new, now_grids

    def run_fn(carry, n_steps):
        if carry_layout(carry) is None:
            for _ in range(n_steps):
                carry = local_step(carry)
            return carry
        dyc, phys, mesh, shard_lon = twin_of(carry)
        local = unwrap_carry(carry)
        for _ in range(n_steps):
            local = local_step(local, dyc, phys)
        return wrap_carry(mesh, local, shard_lon)

    def step_fn(carry, _=None):
        return run_fn(carry, 1), None

    return dycore, init_fn, step_fn, run_fn
