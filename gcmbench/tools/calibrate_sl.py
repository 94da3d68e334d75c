"""Readings that the limits of ``correct`` in the SL cell are set from,
and the planted SL faults that those limits must catch, in one process
at the cell's own size on one CUDA card.  The benchmark's runs never run
this.

    python3 gcmbench/tools/calibrate_sl.py --workload gcm_t85_sl
        --seeds 12 --control-seeds 3 [--fault-picks 0,10]
        [--faults a,b] [--seconds 2] [--first-seed N] [--out FILE]

For each seed: the program against the plain reference
(the six numbers that ``drivers/gcm_sl.py`` compares); on the first
``--control-seeds`` the control, the reference with TF32 matrix
products in the program's place.  Then each planted fault (``FAULTS``)
on one seed for each of ``--fault-picks``, the checked cycle of the
window (0 the first, when the winds of the adjustment from rest are
weakest), with the cell's limits: each must read not correct.  Prints one JSON line per run and a summary: for each
compared number the largest program reading, the smallest control
reading and the smallest reading of each fault.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from gcmbench import harness  # noqa: E402
from gcmbench.drivers import gcm  # noqa: E402
from gcmbench.reference import matmul_precision  # noqa: E402
from gcmbench.reference.gcm_sl import MoistGCM as ReferenceGCM  # noqa: E402


@contextlib.contextmanager
def patched(owner, name, make):
    """``owner.name`` replaced by ``make(real)`` for the block."""
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def sl_class():
    from climt_tpu_torch.ops.sl_advection import SLAdvection
    return SLAdvection


def arrival_points():
    """The field interpolated at the arrival points: departure points
    found on a zero wind."""
    def make(real):
        def departure(self, u, v, dt):
            return real(self, torch.zeros_like(u), torch.zeros_like(v), dt)
        return departure
    return patched(sl_class(), '_departure', make)


class _DropFourthGather:
    """The ``torch`` of the SL module with every fourth ``gather`` (the
    last corner of each bilinear interpolation) reading zeros."""

    def __init__(self, torch_module):
        self._torch = torch_module
        self._calls = 0

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def gather(self, *args, **kw):
        out = self._torch.gather(*args, **kw)
        self._calls += 1
        return out if self._calls % 4 else self._torch.zeros_like(out)


def corner_dropped():
    """One of the four corners left out of every bilinear
    interpolation."""
    from climt_tpu_torch.ops import sl_advection
    return patched(sl_advection, 'torch', _DropFourthGather)


def one_iteration():
    """The departure points from one trajectory iteration, not two."""
    def make(real):
        def departure(self, u, v, dt):
            saved, self.n_iter = self.n_iter, 1
            try:
                return real(self, u, v, dt)
            finally:
                self.n_iter = saved
        return departure
    return patched(sl_class(), '_departure', make)


def fixer_skipped():
    """The global water fixer left out of every step."""
    from climt_tpu_torch.dycore.moist_gcm import MoistGCM
    return patched(MoistGCM, '_fix_water',
                   lambda real: lambda self, new, prev, phys: new)


FAULTS = {'arrival_points': arrival_points,
          'corner_dropped': corner_dropped,
          'one_iteration': one_iteration,
          'fixer_skipped': fixer_skipped}


def numbers(found):
    """{'<stage>.<l2|max>': value} of ``gcm.stage_gaps``'s result."""
    return {'%s.%s' % (s, kind): found[s][i] for s in gcm.STAGES
            for i, kind in enumerate(('l2', 'max'))}


def readings(ctx, step_fn, init_fn, reference, seed, seconds, control):
    """The program's compared numbers on ``seed`` and whether they pass
    the cell's limits, and with ``control`` the control's numbers."""
    rad_every = ctx.config['build']['rad_every']
    s32 = gcm.init_seed(seed)
    carry = init_fn(s32)
    init_state = gcm.clone(carry)
    for _ in range(rad_every):
        carry, _ = step_fn(carry)
    pick = gcm.check_cycle(seed, ctx.traffic['check_steps'], rad_every)
    carry, rec, captured = gcm.window(step_fn, carry, rad_every, seconds,
                                      pick, ctx.device, False)
    del carry
    with matmul_precision('float32'):
        refs = gcm.stage_outputs(reference, captured, s32)
    found = numbers(gcm.stage_gaps(
        gcm.captured_outputs(captured, init_state), refs))
    limits = ctx.cell['limits']
    out = {'seed': seed, 'steps': rec['steps'], 'pick': pick,
           'program': found,
           'correct': harness.correct_of(
               [(n, v, limits[n]) for n, v in found.items()])}
    if control:
        with matmul_precision('tf32'):
            ctrl = gcm.stage_outputs(reference, captured, s32)
        out['control'] = numbers(gcm.stage_gaps(ctrl, refs))
    return out


def seeds_for_picks(first, picks, check_steps, rad_every):
    """For each cycle in ``picks``, the first seed from ``first`` on whose
    check falls on that cycle of the window."""
    out = []
    for pick in picks:
        s = first
        while gcm.check_cycle(s, check_steps, rad_every) != pick:
            s += 1
        out.append(s)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', default='gcm_t85_sl')
    parser.add_argument('--seeds', type=int, default=12)
    parser.add_argument('--first-seed', type=int, default=3000000001)
    parser.add_argument('--control-seeds', type=int, default=3)
    parser.add_argument('--fault-picks', default='0,10',
                        help='the checked cycles of the fault runs')
    parser.add_argument('--faults', default=','.join(FAULTS))
    parser.add_argument('--seconds', type=float, default=2.0)
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    os.environ.pop('CLIMT_TPU_LW_KTABLES', None)
    harness.require_cards(1)
    bench = harness.load_json(harness.ROOT, 'BENCHMARK.json')
    ctx = harness.cell_context(bench, args.workload, args.first_seed,
                               args.seconds, False, time.perf_counter())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = gcm.model_args(ctx.config, ctx.traffic)
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    _, init_fn, step_fn, _ = build_moist_gcm(device='cuda', **model)
    reference = ReferenceGCM(device='cuda', **model)
    lines = []

    def emit(out):
        print(json.dumps(out), flush=True)
        lines.append(out)

    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for n, seed in enumerate(seeds):
        emit(readings(ctx, step_fn, init_fn, reference, seed, args.seconds,
                      n < args.control_seeds))
    fault_seeds = seeds_for_picks(
        args.first_seed + 1, [int(p) for p in args.fault_picks.split(',')],
        ctx.traffic['check_steps'], ctx.config['build']['rad_every'])
    for name in args.faults.split(','):
        for seed in fault_seeds:
            with FAULTS[name]():
                out = readings(ctx, step_fn, init_fn, reference, seed,
                               args.seconds, False)
            out['fault'] = name
            emit(out)

    summary = {}
    for x in lines:
        who = x.get('fault', 'program')
        for key, v in x['program'].items():
            entry = summary.setdefault(key, {'program_max': 0.0})
            if who == 'program':
                entry['program_max'] = max(entry['program_max'], v)
            else:
                entry[who + '_min'] = min(entry.get(who + '_min', v), v)
        for key, v in x.get('control', {}).items():
            entry = summary[key]
            entry['control_min'] = min(entry.get('control_min', v), v)
    verdicts = {name: [x['correct'] for x in lines if x.get('fault') == name]
                for name in FAULTS}
    print(json.dumps({'summary': summary, 'faults_correct': verdicts,
                      'sound_correct': [x['correct'] for x in lines
                                        if 'fault' not in x],
                      'limits': ctx.cell['limits'],
                      'card': torch.cuda.get_device_name(0)}), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({'lines': lines, 'summary': summary,
                       'faults_correct': verdicts}, f, indent=1)


if __name__ == '__main__':
    main()
