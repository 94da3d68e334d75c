"""The repository's two entry points on the port (__graft_entry__.py).

``entry(device='cuda')`` -> ``(fn, (carry,))``: the flagship step, one
step of the fused moist GCM (spectral dynamics, RRTMG radiation, Emanuel
convection, surface physics, slab ocean) at 32x16x10 in float32, with
its initial carry; ``fn(carry)`` returns the stepped spectral
temperature ``carry2[1]['T']``.

``dryrun_multichip(n_devices, device='cuda')``: one m-sharded step held
against one device.  The model is built at ``nlat = 4 n``, ``nlon = 2
nlat``, ``nz = 8`` with the matmul zonal DFT, once on one device and once
over an (n, 1) ('lat', 'lon') mesh (``build_moist_gcm(mesh=...)``: grid
fields in latitude bands, the spectral state in m-blocks through
``parallel.DistributedSHT``).  One step of each, gathered with
``convert.carry_to_global``, must agree in grid space within
__graft_entry__.py:98-111's float32 limits (``FIELD_TOL`` on the
prognostic fields, ``AUX_TOL`` on every aux field) with equal step
indices.

One torch process drives one device.  Inside a running process group of
n ranks (``torchrun``, ``parallel.initialize_distributed``) the check
runs this rank's part; otherwise it spawns n ranks itself
(``parallel.spawn_ranks``), NCCL on ``cuda:<rank>`` or gloo for
``device='cpu'``.  Rank 0 alone builds and steps the single-device
model.  Both entry points run on the card unless the caller asks for
the CPU; without enough cards they raise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .convert import carry_to_global, carry_to_numpy
from .dycore.moist_gcm import build_moist_gcm
from .parallel import make_mesh, spawn_ranks

# __graft_entry__.py:98-111: the prognostic fields in grid space, and the
# aux fields (radiation fluxes are O(100 W/m^2) float32 sums whose order
# of reduction changes under sharding)
FIELDS = ('vort', 'div', 'T', 'q', 'lnps')
FIELD_TOL = dict(rtol=2e-4, atol=1e-5)
AUX_TOL = dict(rtol=5e-4, atol=5e-3)
# seconds for the spawned ranks to start, build both models and step
SPAWN_TIMEOUT = 600.0


def _build(nlon, nlat, nz, dtype=torch.float32, fft_impl='fft', mesh=None,
           device='cuda'):
    """The flagship model: build_moist_gcm at dt 600 s
    (__graft_entry__.py:23)."""
    return build_moist_gcm(nlon=nlon, nlat=nlat, nz=nz, timestep=600.0,
                           dtype=dtype, fft_impl=fft_impl, mesh=mesh,
                           device=device)


def entry(device='cuda'):
    """(fn, (carry,)): the flagship step at 32x16x10 float32 on
    ``device`` and its initial carry; ``fn(carry)`` is one step and
    returns the new spectral temperature (__graft_entry__.py:33)."""
    _, init_fn, step_fn, _ = _build(32, 16, 10, device=device)

    def fn(carry):
        carry2, _ = step_fn(carry)
        return carry2[1]['T']

    return fn, (init_fn(),)


def step_errors(ref, out, synthesize):
    """{field: {'max_abs_err', 'of_limit', 'rtol', 'atol'}} of the carry
    ``out`` against ``ref`` (numpy carries (prev, now, grids, aux, k) in
    the single-device layout, or the Held-Suarez model's (prev, now,
    grids)): the now state's FIELDS in grid space (``synthesize`` maps a
    spectral numpy array to a grid one; a grid field, the 'q' of the grid
    moisture modes, is compared as it is) against FIELD_TOL, every aux
    field, as 'aux <name>', against AUX_TOL, where ``of_limit`` is the
    largest |out - ref| / (atol + rtol |ref|)."""
    def grid(x):
        return synthesize(x) if np.iscomplexobj(x) else x

    pairs = [(name, grid(out[1][name]), grid(ref[1][name]), FIELD_TOL)
             for name in FIELDS if name in ref[1]]
    if len(ref) > 3:
        pairs += [('aux ' + name, out[3][name], b, AUX_TOL)
                  for name, b in ref[3].items()]
    errors = {}
    for name, a, b, tol in pairs:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        diff = np.abs(a - b)
        errors[name] = dict(
            max_abs_err=float(np.max(diff)),
            of_limit=float(np.max(diff / (tol['atol']
                                          + tol['rtol'] * np.abs(b)))),
            **tol)
    return errors


def compare_steps(ref, out, synthesize):
    """Hold the carry ``out`` against ``ref``: ``step_errors``, every
    field within its limit and the step indices equal.  Returns the
    errors; raises AssertionError, naming the field, where one exceeds
    its limit."""
    errors = step_errors(ref, out, synthesize)
    for name, err in errors.items():
        if not err['of_limit'] <= 1.0:
            raise AssertionError(
                'm-sharded vs single mismatch in %r: %.3g of the limit '
                '(rtol %g, atol %g)' % (name, err['of_limit'], err['rtol'],
                                        err['atol']))
    if len(ref) > 4 and int(out[4]) != int(ref[4]):
        raise AssertionError('m-sharded vs single step index %d, not %d'
                             % (int(out[4]), int(ref[4])))
    return errors


def _dryrun_rank(rank, n_devices, device):
    """Rank ``rank``'s part of the check, in a process group of n_devices
    ranks: every rank steps the mesh model and gathers its carry; rank 0
    alone builds and steps the single-device model and compares, and
    every rank returns (or raises) rank 0's verdict."""
    dev = (torch.device('cuda', torch.cuda.current_device())
           if device == 'cuda' else torch.device('cpu'))
    mesh = make_mesh(n_devices, mesh_shape=(n_devices, 1), device=device)
    nlat = 4 * n_devices
    nlon = 2 * nlat
    nz = 8
    dycore, init_fn, step_fn, _ = _build(
        nlon, nlat, nz, fft_impl='matmul', mesh=mesh, device=dev)
    out = carry_to_global(step_fn(init_fn())[0], dycore.sht)
    # [errors, AssertionError's message]
    verdict = [None, None]
    if rank == 0:
        ref_dycore, ref_init, ref_step, _ = _build(
            nlon, nlat, nz, fft_impl='matmul', device=dev)
        ref = carry_to_numpy(ref_step(ref_init())[0])
        sht = ref_dycore.sht

        def synthesize(spec):
            return sht.synthesize(torch.as_tensor(spec, device=dev)).cpu()

        try:
            verdict[0] = compare_steps(ref, out, synthesize)
        except AssertionError as e:
            verdict[1] = str(e)
    dist.broadcast_object_list(verdict, src=0)
    if verdict[1] is not None:
        raise AssertionError(verdict[1])
    return verdict[0]


def dryrun_multichip(n_devices, device='cuda'):
    """One m-sharded step at nlat = 4 n_devices against one device (see
    the module docstring); returns ``compare_steps``'s errors and raises
    where one exceeds its limit.

    In a running process group its size must be n_devices, and
    ``device='cuda'`` needs NCCL; every rank must call this.  Otherwise
    n_devices ranks are spawned, one per card (``device='cuda'``, which
    raises without n_devices cards) or gloo on the CPU."""
    n_devices = int(n_devices)
    device = torch.device(device).type
    if device not in ('cuda', 'cpu'):
        raise ValueError('device %r: expected cuda or cpu' % (device,))
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError('dryrun_multichip(%d) in a process group of %d '
                             'ranks: one rank drives one device' % (
                                 n_devices, dist.get_world_size()))
        if device == 'cuda' and dist.get_backend() != 'nccl':
            raise RuntimeError("dryrun_multichip(device='cuda') needs the "
                               'nccl backend, not %s' % dist.get_backend())
        return _dryrun_rank(dist.get_rank(), n_devices, device)
    return spawn_ranks(_dryrun_rank, n_devices, dict(device=device),
                       device=device, timeout=SPAWN_TIMEOUT)[0]
