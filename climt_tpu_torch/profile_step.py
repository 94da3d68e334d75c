"""Device profile of a fused model's steps on one GPU.

    python -m climt_tpu_torch.profile_step
        [--model moist|moist_fv|moist_sl|held_suarez]
        [--layout single|m_sharded|replicated|replicated_lon]

``moist`` (the default) runs the T85 moist GCM (256x128x28, f32,
rad_every=6, rad_col_chunk=8192) for steps 0-5, then traces step 6 (a
radiation refresh) and step 7 (a step that reuses the stored heating
rates); ``moist_fv`` and ``moist_sl`` do the same with the moisture
moved in grid space (``moisture_advection='fv'``, ``'sl'``).
``held_suarez`` runs the T42 Held-Suarez model of ``bench.py`` (128x64x28,
f32, dt 600 s) for 5 steps, then traces step 5 and step 6.
``--layout`` other than ``single`` starts a world of one NCCL rank and
runs the model in a mesh layout on ``make_mesh(1)``: ``m_sharded``
builds it with ``mesh=`` (moist models only), ``replicated`` and
``replicated_lon`` place the carry of the model built without a mesh
with ``shard_model_state`` (``shard_lon`` False and True).
For each traced step it prints the wall time, the summed kernel time, the
device busy share (kernel time over wall time: one stream, so kernels do
not overlap), the number of kernel launches, the collectives (calls and
bytes of the all_to_all transposes, the latitude halo, the all_reduce
and all_gather calls) and the kernels that take the most device time;
then one row per layer: the innermost program span (``climt.*``, see
``utils.profiling.phase``) over each instant of the host's work, its
host self ms, and the kernel launches and device ms of the operations
launched inside it (each kernel is tied to the operation that launched
it, so these device times are exact; launches the profile ties to no
operation get a row of their own).  Wall times include the profiler's
own overhead.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .dycore.compiled import build_held_suarez_model
from .dycore.moist_gcm import build_moist_gcm
from .parallel import (dist_sht, halo, initialize_distributed, make_mesh,
                       rep_sht, shard_model_state)

# the moist GCM's moisture transport of each --model
MOISTURE = {'moist': 'spectral', 'moist_fv': 'fv', 'moist_sl': 'sl'}
LAYOUTS = ('single', 'm_sharded', 'replicated', 'replicated_lon')


# the program's collectives, each counting its calls and bytes
COLLECTIVES = {'all_to_all': dist_sht.transpose, 'halo': halo.LatHalo,
               'all_reduce': rep_sht.all_reduce_sum,
               'all_gather': rep_sht.all_gather_cat}
SPAN = 'climt.'
NO_SPAN = '(no program span)'


def reset_collectives():
    for counter in COLLECTIVES.values():
        counter.calls = counter.bytes = 0


def collectives():
    """{collective: (calls, bytes)} since ``reset_collectives``."""
    return {name: (c.calls, c.bytes) for name, c in COLLECTIVES.items()}


@contextlib.contextmanager
def world_of_one(device='cuda'):
    """A process group of one rank (its rendezvous a FileStore in a
    temporary directory) and its (1, 1) mesh, left when the block ends."""
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed('file://' + os.path.join(tmp, 'store'), 1, 0,
                               device=device)
        try:
            yield make_mesh(1, device=device)
        finally:
            dist.destroy_process_group()


def _annotation(e):
    """A span's mark on the device's timeline: no operation."""
    return (getattr(e, 'is_user_annotation', False)
            or 'annotation' in str(getattr(e, 'activity_type', '')).lower())


def _kernel_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not _annotation(e)]


def _span_of(e):
    """The innermost program span around host event e (e itself if it is
    one), or None."""
    while e is not None and not e.name.startswith(SPAN):
        e = e.cpu_parent
    return e


def layers(prof):
    """{innermost program span: [spans, host self ms, kernel launches,
    device ms]} of a profile; the host's self ms is a span's length less
    that of the program spans nested in it."""
    out = {}
    host = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]
    for e in host:
        if e.name.startswith(SPAN):
            row = out.setdefault(e.name, [0, 0.0, 0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us() / 1e3
            outer = _span_of(e.cpu_parent)
            if outer is not None:
                out.setdefault(outer.name, [0, 0.0, 0, 0.0])[1] -= (
                    e.time_range.elapsed_us() / 1e3)
        if getattr(e, 'kernels', None):
            span = _span_of(e)
            row = out.setdefault(span.name if span else NO_SPAN,
                                 [0, 0.0, 0, 0.0])
            row[2] += len(e.kernels)
            row[3] += sum(k.duration for k in e.kernels) / 1e3
    return out


def _build(model, dev, layout='single', mesh=None):
    """(step_fn, carry, warm-up steps, labels of the traced steps)."""
    if model in MOISTURE:
        _, init_fn, step_fn, _ = build_moist_gcm(
            nlon=256, nlat=128, nz=28, timestep=600.0, dtype=torch.float32,
            rad_every=6, rad_col_chunk=8192, device=dev,
            moisture_advection=MOISTURE[model],
            mesh=mesh if layout == 'm_sharded' else None)
        warm, labels = 6, ('radiation step (k=6)', 'plain step (k=7)')
    else:
        if layout == 'm_sharded':
            raise ValueError('the m-sharded layout is the moist GCM\'s')
        _, init_fn, step_fn, _ = build_held_suarez_model(
            nlon=128, nlat=64, nz=28, timestep=600.0, dtype=torch.float32,
            device=dev)
        warm, labels = 5, ('held-suarez T42 step (k=5)',
                           'held-suarez T42 step (k=6)')
    carry = init_fn(0)
    if layout.startswith('replicated'):
        carry = shard_model_state(mesh, *carry,
                                  shard_lon=layout == 'replicated_lon')
    return step_fn, carry, warm, labels


def traced_step(step_fn, carry):
    """One traced step: (carry, wall s, the profile)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry, _ = step_fn(carry, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return carry, wall, prof


def kernel_summary(prof):
    """(kernel s, kernel launches, {kernel name: (ms, launches)})."""
    kernels = _kernel_events(prof)
    busy = sum(e.device_time_total for e in kernels) / 1e6   # us -> s
    by_name = {}
    for e in kernels:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.device_time_total / 1e3, n + 1)
    return busy, len(kernels), by_name


def profile_one(step_fn, carry):
    """One traced step: (carry, wall s, kernel s, kernel launches, {kernel
    name: (ms, launches)})."""
    carry, wall, prof = traced_step(step_fn, carry)
    return (carry, wall) + kernel_summary(prof)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--model', choices=tuple(MOISTURE) + (
        'held_suarez',), default='moist')
    parser.add_argument('--layout', choices=LAYOUTS, default='single')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA GPU')
    if args.model not in MOISTURE and args.layout == 'm_sharded':
        parser.error('--layout m_sharded needs a moist --model')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with (contextlib.nullcontext() if args.layout == 'single'
          else world_of_one()) as mesh:
        step_fn, carry, warm, labels = _build(
            args.model, torch.device('cuda:0'), args.layout, mesh)
        for _ in range(warm):
            carry, _ = step_fn(carry, None)
        torch.cuda.synchronize()
        for label in labels:
            reset_collectives()
            carry, wall, prof = traced_step(step_fn, carry)
            busy, launches, by_name = kernel_summary(prof)
            print('%s, layout %s, on %s: wall %.4f s, kernel time %.4f s, '
                  'device busy %.1f%%, %d kernel launches, collectives '
                  '(calls, bytes) %s' % (
                      label, args.layout, card, wall, busy,
                      100.0 * busy / wall, launches, collectives()))
            for name, (ms, n) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][0])[:15]:
                print('    %9.3f ms %6d x  %s' % (ms, n, name[:100]))
            print('    %-20s %6s %12s %9s %10s' % (
                'innermost span', 'spans', 'host self ms', 'launches',
                'device ms'))
            rows = layers(prof)
            for name, (n, host_ms, k, dev_ms) in sorted(
                    rows.items(), key=lambda kv: -kv[1][1]):
                print('    %-20s %6d %12.3f %9d %10.3f' % (
                    name, n, host_ms, k, dev_ms))
            # launches that the profile ties to no host operation
            print('    %-20s %6s %12s %9d %10.3f' % (
                '(tied to no op)', '', '',
                launches - sum(r[2] for r in rows.values()),
                1e3 * busy - sum(r[3] for r in rows.values())))


if __name__ == '__main__':
    main()
