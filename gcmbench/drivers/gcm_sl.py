"""One card stepping the moist GCM with semi-Lagrangian moisture.

The run of ``drivers/gcm.py`` (set-up, warm-up cycle, window, traced
cycle, the check of one cycle's refresh and plain steps), with its own
yardstick where the SL mode differs: the plain reference is
``reference/gcm_sl.py``, the counted operations ``costs/gcm_sl.py``, and
the program's gather counter (``SLAdvection.gather_bytes``) is read
before and after the window.  A program that has no such counter gives
None there, and ``sl_gather_mb_per_step`` reads nothing.
"""

from __future__ import annotations

import gc
import time

import torch

from gcmbench import harness, tracing
from gcmbench.costs import gcm_sl as cost
from gcmbench.drivers import gcm
from gcmbench.reference import matmul_precision
from gcmbench.reference.gcm_sl import MoistGCM as ReferenceGCM


def gather_bytes():
    """The program's SL gather bytes so far, or None where it counts
    none."""
    from climt_tpu_torch.ops.sl_advection import SLAdvection
    return getattr(SLAdvection, 'gather_bytes', None)


def run(ctx):
    b = ctx.config['build']
    step_fn, carry = gcm.stepping(ctx)
    init_state = gcm.clone(carry)
    rad_every = b['rad_every']
    for _ in range(rad_every):
        carry, _ = step_fn(carry)
    harness.sync(ctx.device)
    ctx.mark('warm-up')
    setup_s = time.perf_counter() - ctx.t_start

    pick = gcm.check_cycle(ctx.seed, ctx.traffic['check_steps'], rad_every)
    before = gather_bytes()
    carry, rec, captured = gcm.window(step_fn, carry, rad_every,
                                      ctx.seconds, pick, ctx.device,
                                      ctx.trace)
    after = gather_bytes()
    rec['sl_gather_bytes'] = None if before is None else after - before
    breakdown = None
    if ctx.trace:
        def cycle():
            c = carry
            for j in range(rad_every):
                with tracing.span('refresh_step' if j == 0
                                  else 'plain_step'):
                    c, _ = step_fn(c)
            return c
        _, trace = tracing.profiled(cycle, ctx.device)
        rec['trace'] = trace
        rec['trace_steps'] = rad_every
        breakdown = {'device_ops': trace.top_device_ops(),
                     'idle_gaps': trace.longest_gaps()}
    dev = harness.device_entry(ctx.device)
    if ctx.trace:
        dev.update(busy_s=rec['trace'].busy_s(),
                   window_s=rec['trace'].window_s)
    rec['window_flops'] = rec['cycles'] * cost.cycle_flops(
        b['nlon'], b['nlat'], b['nz'], rad_every)
    e2e = {ctx.cell['throughput']: gcm.years_per_day(rec, b['timestep']),
           'setup_s': setup_s}

    del step_fn, carry
    gc.collect()
    if torch.device(ctx.device).type == 'cuda':
        torch.cuda.empty_cache()
    with matmul_precision('float32'):
        reference = ReferenceGCM(device=ctx.device,
                                 **gcm.model_args(ctx.config, ctx.traffic))
        found = gcm.stage_gaps(gcm.captured_outputs(captured, init_state),
                               gcm.stage_outputs(reference, captured,
                                                 gcm.init_seed(ctx.seed)))
    checks = gcm.checks_of(found, ctx.cell['limits'])
    return harness.Result(e2e=e2e, record=rec, checks=checks,
                          attempted=rec['steps'],
                          failed=gcm.failed_steps(checks),
                          device=dev, breakdown=breakdown)
