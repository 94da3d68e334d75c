"""One card stepping the moist GCM, as a user's run loop does.

Set-up builds the program's model (``build_moist_gcm``), draws the
initial state from the seed (``init_fn``) and runs one radiation cycle:
its refresh step and first plain step warm every shape the window uses,
and the cycle's other plain steps start the window at a refresh.  The
window then calls ``step_fn`` back to back, with no synchronize inside,
and ends at the first completed radiation cycle after ``--seconds``, so
it always holds the model's mix of refresh and plain steps.

A traced run times each cycle's refresh step alone and its plain steps
together (a synchronize at each boundary), and after the window
profiles one more whole cycle, kept in memory.

The check: the seed picks one of the cycles that hold the window's
first ``check_steps`` steps (fewer than the slowest measured window
ran); its refresh step's input, and that step's and the next
(plain) step's outputs, are kept.  After the window the program is
freed and the plain reference steps from the program's own state: the
refresh step from its input, the plain step from the program's refresh
output.  The start, which this skips, is checked by itself: the
reference's initial state from the seed against the program's.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from gcmbench import compare, harness, tracing
from gcmbench.costs import gcm as gcm_cost
from gcmbench.reference import matmul_precision
from gcmbench.reference.gcm import MoistGCM as ReferenceGCM

DTYPES = {'float32': torch.float32, 'float64': torch.float64}
STAGES = ('init', 'refresh', 'plain')
# the radiation's own outputs in the carry and the diagnostics: float32
# RRTMG-SW moves its heating rates by up to tenths of their largest value
# from a one-ulp change of its inputs (PERF.md), so they are held by
# ``l2`` and not by ``max``
RADIATION_FIELDS = ('hr_rad', 'sfc_rad', 'olr', 'asr')


def state_field(path):
    """True for a compared field that ``max`` holds: every field but the
    radiation's outputs."""
    return path.rsplit('/', 1)[-1] not in RADIATION_FIELDS


def model_args(config, traffic):
    """The keyword arguments both models are built with."""
    b = config['build']
    return dict(nlon=b['nlon'], nlat=b['nlat'], nz=b['nz'],
                timestep=b['timestep'], rad_every=b['rad_every'],
                rad_col_chunk=b['rad_col_chunk'],
                dtype=DTYPES[b['dtype']],
                moisture_advection=traffic['moisture_advection'])


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone(x) for x in tree)
    return tree.detach().clone() if torch.is_tensor(tree) else tree


def init_seed(seed):
    """The numpy seed of ``init_fn``: the run's seed folded into 32 bits."""
    return int(seed) % (2 ** 32)


def check_cycle(seed, check_steps, rad_every):
    """The window's cycle whose steps are compared, drawn from the seed
    among those that hold its first ``check_steps`` steps."""
    cycles = max(1, check_steps // rad_every)
    return int(np.random.default_rng(int(seed)).integers(cycles))


def stepping(ctx):
    """(step_fn, first carry) of the program's model; marks the phases of
    set-up it goes through."""
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    ctx.mark('port import')
    harness.open_card(ctx.device)
    ctx.mark('card')
    if torch.device(ctx.device).type == 'cuda':
        from climt_tpu_torch import _build
        _build.library()
    ctx.mark('kernels')
    _, init_fn, step_fn, _ = build_moist_gcm(
        device=ctx.device, **model_args(ctx.config, ctx.traffic))
    ctx.mark('model')
    carry = init_fn(init_seed(ctx.seed))
    harness.sync(ctx.device)
    ctx.mark('state')
    return step_fn, carry


def window(step_fn, carry, rad_every, seconds, pick, device, trace,
           agree=None):
    """Run whole cycles until ``seconds`` have passed and cycle ``pick``
    is done.  Returns (carry, record, captured): the window's steps and
    seconds (and, when traced, the step times), and the captured states.
    ``agree(done)``: where several ranks step one model, every rank's
    decision to stop, taken from rank 0's."""
    record = dict(steps=0, cycles=0, refresh_s=[], plain_s=[],
                  plain_steps=0)
    captured = {}
    t0 = time.perf_counter()
    while True:
        mine = record['cycles'] == pick
        if mine:
            captured['refresh_in'] = clone(carry)
        if trace:
            harness.sync(device)
            ta = time.perf_counter()
        with tracing.span('refresh_step'):
            carry, diag = step_fn(carry)
        if mine:
            captured['refresh_out'] = clone((carry, diag))
        if trace:
            harness.sync(device)
            tb = time.perf_counter()
        for j in range(1, rad_every):
            with tracing.span('plain_step'):
                carry, diag = step_fn(carry)
            if mine and j == 1:
                captured['plain_out'] = clone((carry, diag))
        if trace:
            harness.sync(device)
            record['refresh_s'].append(tb - ta)
            record['plain_s'].append(time.perf_counter() - tb)
            record['plain_steps'] += rad_every - 1
        record['cycles'] += 1
        record['steps'] += rad_every
        done = (time.perf_counter() - t0 >= seconds
                and record['cycles'] > pick)
        if agree is not None:
            done = agree(done)
        if done:
            break
    harness.sync(device)
    record['window_s'] = time.perf_counter() - t0
    return carry, record, captured


def captured_outputs(captured, init_state):
    """The program's outputs of the three compared stages."""
    return {'init': init_state, 'refresh': captured['refresh_out'],
            'plain': captured['plain_out']}


def stage_outputs(model, captured, seed):
    """A reference model's outputs of the three stages from the captured
    inputs: its initial state from the seed, the refresh step from the
    program's input to it, the plain step from the program's output of
    the refresh step."""
    return {'init': model.init(seed),
            'refresh': model.step(captured['refresh_in']),
            'plain': model.step(captured['refresh_out'][0])}


def stage_gaps(outs, refs):
    """{stage: (l2, max, worst field)}: ``l2`` over every field, ``max``
    over every field but the radiation's outputs."""
    return {s: compare.gaps(outs[s], refs[s], state_field) for s in STAGES}


def checks_of(found, limits):
    return [('%s.%s' % (s, kind), found[s][i], limits['%s.%s' % (s, kind)])
            for s in STAGES for i, kind in enumerate(('l2', 'max'))]


def failed_steps(checks):
    """How many of the two compared steps of the window failed."""
    return sum(1 for s in ('refresh', 'plain')
               if not harness.correct_of(
                   [c for c in checks if c[0].startswith(s + '.')]))


def years_per_day(rec, timestep):
    """Simulated years per wall-clock day of the window."""
    years = rec['steps'] * timestep / (365.0 * 86400.0)
    return years / (rec['window_s'] / 86400.0)


def run(ctx):
    b = ctx.config['build']
    step_fn, carry = stepping(ctx)
    init_state = clone(carry)
    rad_every = b['rad_every']
    for _ in range(rad_every):
        carry, _ = step_fn(carry)
    harness.sync(ctx.device)
    ctx.mark('warm-up')
    setup_s = time.perf_counter() - ctx.t_start

    pick = check_cycle(ctx.seed, ctx.traffic['check_steps'], rad_every)
    carry, rec, captured = window(step_fn, carry, rad_every, ctx.seconds,
                                  pick, ctx.device, ctx.trace)
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
    rec['window_flops'] = rec['cycles'] * gcm_cost.cycle_flops(
        b['nlon'], b['nlat'], b['nz'], rad_every,
        ctx.traffic['moisture_advection'])
    e2e = {ctx.cell['throughput']: years_per_day(rec, b['timestep']),
           'setup_s': setup_s}

    del step_fn, carry
    gc.collect()
    if torch.device(ctx.device).type == 'cuda':
        torch.cuda.empty_cache()
    with matmul_precision('float32'):
        reference = ReferenceGCM(device=ctx.device,
                                 **model_args(ctx.config, ctx.traffic))
        found = stage_gaps(captured_outputs(captured, init_state),
                           stage_outputs(reference, captured,
                                         init_seed(ctx.seed)))
    checks = checks_of(found, ctx.cell['limits'])
    return harness.Result(e2e=e2e, record=rec, checks=checks,
                          attempted=rec['steps'],
                          failed=failed_steps(checks),
                          device=dev, breakdown=breakdown)
