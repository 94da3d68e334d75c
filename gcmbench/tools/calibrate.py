"""Readings that the limits of ``correct`` are set from: the program
against the plain reference on many seeds, and the control (the
reference in the next precision below the configuration's, in the
program's place) against the reference on a few, all in one process at
the cell's own size.  The benchmark's runs never run this.

    python3 gcmbench/tools/calibrate.py --workload gcm_t85 --seeds 12
        --control tf32 --control-seeds 3 [--seconds 2] [--first-seed N]
        [--out FILE]

Prints one JSON line per seed and a summary: for each compared number
the largest program reading (the lower one) and the smallest control
reading (the upper one).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from gcmbench import compare, harness  # noqa: E402
from gcmbench.drivers import gcm, rad  # noqa: E402
from gcmbench.reference import gas_mix, matmul_precision  # noqa: E402
from gcmbench.reference.gcm import MoistGCM as ReferenceGCM  # noqa: E402


@contextlib.contextmanager
def bf16_gas_optics():
    """The reference's gas optics with its tables and weights rounded to
    bfloat16 (the sums stay float32): the step a kernel-B change that
    stores them in 16 bits would take."""
    real = gas_mix.mix_groups_plain

    def mix(layout, idx, w):
        packed = copy.copy(layout)
        packed.table = layout.table.to(torch.bfloat16).to(layout.table.dtype)
        return real(packed, idx, w.to(torch.bfloat16).to(w.dtype))
    gas_mix.mix_groups_plain = mix
    try:
        yield
    finally:
        gas_mix.mix_groups_plain = real


def control_run(kind, fn):
    """fn() computed as the control ``kind``: 'tf32' (float32 matrix
    products in TF32) or 'bf16_gas' (the gas optics' tables and weights
    in bfloat16)."""
    if kind == 'bf16_gas':
        with matmul_precision('float32'), bf16_gas_optics():
            return fn()
    with matmul_precision('tf32'):
        return fn()


def gcm_readings(ctx, seeds, control, control_seeds, seconds):
    args = gcm.model_args(ctx.config, ctx.traffic)
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    _, init_fn, step_fn, _ = build_moist_gcm(device='cuda', **args)
    reference = ReferenceGCM(device='cuda', **args)
    rad_every = ctx.config['build']['rad_every']
    for n, seed in enumerate(seeds):
        s32 = gcm.init_seed(seed)
        carry = init_fn(s32)
        init_state = gcm.clone(carry)
        for _ in range(rad_every):
            carry, _ = step_fn(carry)
        pick = gcm.check_cycle(seed, ctx.traffic['check_steps'],
                               rad_every)
        carry, rec, captured = gcm.window(step_fn, carry, rad_every,
                                          seconds, pick, 'cuda', False)
        del carry
        with matmul_precision('float32'):
            refs = gcm.stage_outputs(reference, captured, s32)
        out = {'seed': seed, 'steps': rec['steps'], 'pick': pick,
               'program': gcm.stage_gaps(
                   gcm.captured_outputs(captured, init_state), refs)}
        if n < control_seeds:
            ctrl = control_run(control, lambda: gcm.stage_outputs(
                reference, captured, s32))
            out['control'] = gcm.stage_gaps(ctrl, refs)
        yield out


def rad_readings(ctx, seeds, control, control_seeds, seconds):
    block = ctx.cell['reference_block']
    for n, seed in enumerate(seeds):
        ctx.seed = seed
        data = rad.slices(ctx)
        chosen = rad.picks(seed, ctx.traffic['check_first'],
                           ctx.traffic['check_calls'])
        out = {'seed': seed, 'program': [], 'fields': [], 'control': [],
               'control_fields': []}
        for i in chosen:
            inputs = data[i % len(data)]
            mine = {k: v.clone() for k, v in rad.pair(inputs).items()}
            with matmul_precision('float32'):
                ref = rad.reference_pair(inputs, block)
            out['program'].append(rad.pair_gaps(mine, ref))
            out['fields'].append(compare.field_gaps(mine, ref))
            if n < control_seeds:
                c = control_run(control, lambda: rad.reference_pair(
                    inputs, block))
                out['control'].append(rad.pair_gaps(c, ref))
                out['control_fields'].append(compare.field_gaps(c, ref))
        for key in ('program', 'control'):
            if out[key]:
                out[key] = {k: max(f[k] for f in out[key])
                            for k in out[key][0]}
            else:
                del out[key]
        yield out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, default=12)
    parser.add_argument('--first-seed', type=int, default=3000000001)
    parser.add_argument('--control', choices=('tf32', 'bf16_gas'),
                        default='tf32')
    parser.add_argument('--control-seeds', type=int, default=3)
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
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    gen = {'gcm': gcm_readings, 'rad': rad_readings}[ctx.cell['driver']]
    lines = []
    for out in gen(ctx, seeds, args.control, args.control_seeds,
                   args.seconds):
        print(json.dumps(out), flush=True)
        lines.append(out)
    summary = {}
    for x in lines:
        for who in ('program', 'control'):
            for key, val in x.get(who, {}).items():
                for name, v in (zip(('%s.l2' % key, '%s.max' % key), val)
                                if isinstance(val, (list, tuple))
                                else [(key, val)]):
                    entry = summary.setdefault(name, {'program_max': 0.0,
                                                      'control_min': None})
                    if who == 'program':
                        entry['program_max'] = max(entry['program_max'], v)
                    elif entry['control_min'] is None or \
                            v < entry['control_min']:
                        entry['control_min'] = v
    print(json.dumps({'summary': summary, 'control': args.control,
                      'card': torch.cuda.get_device_name(0)}), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({'lines': lines, 'summary': summary}, f, indent=1)


if __name__ == '__main__':
    main()
