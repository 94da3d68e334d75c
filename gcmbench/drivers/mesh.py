"""The moist GCM m-sharded over a mesh of cards, one rank per card, as a
user spreads a T170 run over the cards of one host.

The parent builds the kernel library once, then starts one process per
card (``parallel.spawn_ranks``: NCCL, a FileStore rendezvous in a
temporary directory under ``TMPDIR``) and waits for all of them; only
the parent prints.  Each rank builds the model with
``build_moist_gcm(mesh=make_mesh(n, (n, 1)))``, draws its block of the
initial state from the seed and runs one radiation cycle as set-up.
The window is ``drivers.gcm.window`` on every rank; after each cycle
rank 0's decision to stop is broadcast over a gloo group (the host's
side only), so every rank runs the same steps.  Rank 0's clock gives
the window.  A traced run then profiles one more cycle on every rank.

The check: the captured states of every rank are gathered into the
global carry (``convert.carry_to_global``), and rank 0, once the
program is freed, steps the one-card plain reference from them: the
gathered result of the collectives is what is compared.
"""

from __future__ import annotations

import gc
import time

import torch

from gcmbench import harness, tracing
from gcmbench.costs import gcm as gcm_cost
from gcmbench.drivers import gcm
from gcmbench.reference import matmul_precision
from gcmbench.reference.gcm import MoistGCM as ReferenceGCM


def counters():
    """The bytes handed to the program's collectives so far, by counter."""
    from climt_tpu_torch.parallel import dist_sht, halo, rep_sht
    return {'transpose': dist_sht.transpose.bytes,
            'lat_halo': halo.LatHalo.bytes,
            'all_reduce_sum': rep_sht.all_reduce_sum.bytes,
            'all_gather_cat': rep_sht.all_gather_cat.bytes}


def to_device(tree, device):
    """A gathered numpy carry as tensors on ``device`` (the step index as
    an int)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(x, device) for x in tree)
    if getattr(tree, 'ndim', 1) == 0:
        return int(tree)
    return torch.as_tensor(tree, device=device)


def gathered(captured, init_state, sht):
    """The global carries and diagnostics of every compared stage, as
    numpy; every rank calls it."""
    from climt_tpu_torch import convert
    out = {'init': convert.carry_to_global(init_state, sht),
           'refresh_in': convert.carry_to_global(captured['refresh_in'],
                                                 sht)}
    for stage in ('refresh_out', 'plain_out'):
        carry, diag = captured[stage]
        out[stage] = (convert.carry_to_global(carry, sht),
                      convert.carry_to_global((diag,), sht)[0])
    return out


def rank_main(rank, world, ctx):
    """One rank of the run; rank 0 returns the record and the compared
    numbers, every rank its peak memory, trace summary and loaded
    modules."""
    import torch.distributed as dist
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    from climt_tpu_torch.parallel import make_mesh
    on_card = torch.device(ctx.device).type == 'cuda'
    device = 'cuda:%d' % rank if on_card else 'cpu'
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = ctx.config['build']
    ctx.mark('rank start')
    mesh = make_mesh(world, mesh_shape=(world, 1), device=ctx.device)
    control = dist.new_group(backend='gloo')
    ctx.mark('process groups')
    dycore, init_fn, step_fn, _ = build_moist_gcm(
        mesh=mesh, device=device, **gcm.model_args(ctx.config, ctx.traffic))
    ctx.mark('model')
    carry = init_fn(gcm.init_seed(ctx.seed))
    init_state = gcm.clone(carry)
    harness.sync(device)
    ctx.mark('state')
    rad_every = b['rad_every']
    for _ in range(rad_every):
        carry, _ = step_fn(carry)
    harness.sync(device)
    ctx.mark('warm-up')
    dist.barrier(group=control)
    ctx.mark('barrier')
    setup_s = time.perf_counter() - ctx.t_start

    def agree(done):
        flag = [done]
        dist.broadcast_object_list(flag, src=0, group=control)
        return flag[0]

    before = counters()
    pick = gcm.check_cycle(ctx.seed, ctx.traffic['check_steps'], rad_every)
    carry, rec, captured = gcm.window(step_fn, carry, rad_every,
                                      ctx.seconds, pick, device, ctx.trace,
                                      agree)
    after = counters()
    rec['collective_bytes'] = {k: after[k] - before[k] for k in after}
    out = {}
    if ctx.trace:
        def cycle():
            c = carry
            for j in range(rad_every):
                with tracing.span('refresh_step' if j == 0
                                  else 'plain_step'):
                    c, _ = step_fn(c)
            return c
        _, trace = tracing.profiled(cycle, device)
        out.update(busy_s=trace.busy_s(), window_s=trace.window_s)
        rec['trace'] = trace
        rec['trace_steps'] = rad_every
    entry = harness.device_entry(device if on_card else 'cpu')
    out.update(memory_peak_bytes=entry['memory_peak_bytes'],
               kind=entry['kind'])
    glob = gathered(captured, init_state, dycore.sht)
    dist.barrier(group=control)
    if rank != 0:
        out['modules'] = harness.forbidden_modules()
        return out

    del step_fn, carry, captured, init_state, dycore
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    glob = to_device(glob, device)
    with matmul_precision('float32'):
        reference = ReferenceGCM(device=device,
                                 **gcm.model_args(ctx.config, ctx.traffic))
        found = gcm.stage_gaps(
            {'init': glob['init'], 'refresh': glob['refresh_out'],
             'plain': glob['plain_out']},
            gcm.stage_outputs(reference, glob, gcm.init_seed(ctx.seed)))
    rec['window_flops'] = rec['cycles'] * gcm_cost.cycle_flops(
        b['nlon'], b['nlat'], b['nz'], rad_every,
        ctx.traffic['moisture_advection'])
    rec['chips'] = world
    out.update(record=rec, found=found, setup_s=setup_s, marks=ctx.marks)
    # the last act of the rank: what it loaded after its window too
    out['modules'] = harness.forbidden_modules()
    return out


def run(ctx):
    from climt_tpu_torch.parallel import spawn_ranks
    world = ctx.workload['chips']
    ctx.mark('port import')
    if torch.device(ctx.device).type == 'cuda':
        from climt_tpu_torch import _build
        _build.library()
    ctx.mark('kernels')
    ranks = spawn_ranks(rank_main, world, {'ctx': ctx}, device=ctx.device,
                        timeout=330.0)
    first = ranks[0]
    rec = first['record']
    bad = sorted({m for r in ranks for m in r['modules']})
    if bad:
        raise RuntimeError('a rank loaded %s' % ', '.join(bad))
    # rank 0's phases, after the parent's (one clock for the machine)
    ctx.marks.extend(first['marks'][len(ctx.marks):])
    # the parent never touches a card: each is its rank's alone
    dev = {'platform': 'gpu' if first['kind'] != 'cpu' else 'cpu',
           'kind': first['kind'], 'count': world,
           'memory_peak_bytes': max(r['memory_peak_bytes'] for r in ranks)}
    breakdown = None
    if ctx.trace:
        dev.update(busy_s=sum(r['busy_s'] for r in ranks) / world,
                   window_s=sum(r['window_s'] for r in ranks) / world)
        trace = rec['trace']
        breakdown = {'device_ops': trace.top_device_ops(),
                     'idle_gaps': trace.longest_gaps()}
    e2e = {ctx.cell['throughput']: gcm.years_per_day(
        rec, ctx.config['build']['timestep']), 'setup_s': first['setup_s']}
    checks = gcm.checks_of(first['found'], ctx.cell['limits'])
    return harness.Result(e2e=e2e, record=rec, checks=checks,
                          attempted=rec['steps'],
                          failed=gcm.failed_steps(checks),
                          device=dev, breakdown=breakdown)
