"""The general part of a run: find the cell's files by name, check the
card, hand the cell to its driver, read the per-layer metrics, check
that no JAX was loaded, and print the result.

A driver (``drivers/<name>.py``) has ``run(ctx)`` returning a ``Result``;
a per-layer metric (``metrics/<name>.py``) has ``read(record)`` returning
a number or None (nothing to read in this cell).  Everything a cell, a
configuration, a traffic mix or a metric needs is found by its name in
``BENCHMARK.json``, so a new one is a new file.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may load: JAX and the JAX package
# (compared whole: the port's own name begins with the JAX package's)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'climt_tpu')


class NoCard(RuntimeError):
    """The machine has fewer CUDA cards than the cell asks for."""


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell's entries and files, the run's
    arguments and the clock reading at process start."""
    workload: dict
    config: dict
    traffic: dict
    cell: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = 'cuda'
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, phase):
        """Note the end of a phase of set-up on the clock of ``t_start``
        (``time.perf_counter``, one clock for every process of the
        machine)."""
        self.marks.append((phase, time.perf_counter()))


@dataclasses.dataclass
class Result:
    """What a driver returns.  ``e2e``: the end-to-end metrics by name;
    ``record``: what the per-layer readers read; ``checks``: (name, value,
    limit) of each number compared with the reference; ``device``: the
    result line's device entry."""
    e2e: dict
    record: dict
    checks: list
    attempted: int
    failed: int
    device: dict
    breakdown: dict = None


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def module_path(kind, name):
    """``gcmbench/<kind>/<name>.py``, or where there is no such file, the
    file of the name's part before its first dot: one reader serves
    ``mfu.gcm`` and ``mfu.rad`` where their arithmetic is the same."""
    path = os.path.join(HERE, kind, name + '.py')
    if not os.path.exists(path) and '.' in name:
        path = os.path.join(HERE, kind, name.split('.')[0] + '.py')
    return path


def load_module(kind, name):
    """``module_path(kind, name)`` as a module (names may hold dots)."""
    path = module_path(kind, name)
    spec = importlib.util.spec_from_file_location(
        'gcmbench_%s_%s' % (kind, name.replace('.', '_').replace('-', '_')),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_context(bench, name, seed, seconds, trace, t_start,
                 device='cuda'):
    """The Context of workload ``name`` of the parsed ``BENCHMARK.json``."""
    workloads = {w['name']: w for w in bench['workloads']}
    if name not in workloads:
        raise SystemExit('no workload %r in BENCHMARK.json (have %s)' % (
            name, ', '.join(sorted(workloads))))
    w = workloads[name]
    config = next(c for c in bench['configs'] if c['name'] == w['config'])
    return Context(
        workload=w, config=load_json(ROOT, config['file']),
        traffic=load_json(HERE, 'traffic', w['traffic'] + '.json'),
        cell=load_json(HERE, 'workloads', name + '.json'),
        seed=int(seed), seconds=float(seconds), trace=bool(trace),
        t_start=t_start, device=device)


def sync(device):
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    import torch
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def device_entry(device, chips=1):
    """The result line's device entry; read before the reference runs,
    so the peak is the program's."""
    import torch
    if torch.device(device).type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': chips,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': chips,
            'memory_peak_bytes': int(torch.cuda.max_memory_allocated())}


def open_card(device):
    """Create the card's context now, so that set-up shows it as a phase
    of its own (nothing to do on the CPU)."""
    import torch
    if torch.device(device).type == 'cuda':
        torch.empty(1, device=device)
        torch.cuda.synchronize()


def require_cards(n):
    """Raise NoCard unless this machine has ``n`` CUDA cards."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard('no CUDA card: torch.cuda.is_available() is False')
    if torch.cuda.device_count() < n:
        raise NoCard('the cell needs %d CUDA cards, this machine has %d'
                     % (n, torch.cuda.device_count()))


def per_layer(bench, name, record):
    """{metric: {'value', 'unit'}} of every per-layer metric that this
    cell reports and whose reader finds something to read."""
    e2e_here = set(record.get('e2e_names', ()))
    out = {}
    for m in bench['per_layer']:
        cells = m.get('workloads')
        if cells is not None and name not in cells:
            continue
        if cells is None and m['moves'] not in e2e_here:
            continue
        value = load_module('metrics', m['name']).read(record)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def correct_of(checks):
    return all(math.isfinite(v) and v <= limit for _, v, limit in checks)


def setup_phases(t_start, marks):
    """One line of the seconds each phase of set-up took, in order."""
    parts, last = [], t_start
    for phase, t in marks:
        parts.append('%s %.3f s' % (phase, t - last))
        last = t
    return 'setup: ' + ', '.join(parts) + ' (%.3f s in all)' % (
        last - t_start)


def result_line(result, metrics, trace):
    """The last line of standard output, the compared numbers last."""
    line = {'correct': correct_of(result.checks),
            'attempted': result.attempted, 'failed': result.failed,
            'metrics': metrics, 'device': result.device}
    if trace and result.breakdown:
        line['breakdown'] = result.breakdown
    line['compared'] = {n: {'value': v, 'limit': limit}
                        for n, v, limit in result.checks}
    return json.dumps(line)


def run_cell(name, seed, seconds, trace, t_start):
    """Run one cell; returns the process's exit code."""
    bench = load_json(ROOT, 'BENCHMARK.json')
    ctx = cell_context(bench, name, seed, seconds, trace, t_start)
    try:
        require_cards(ctx.workload['chips'])
    except NoCard as e:
        print('gcmbench: %s' % e, file=sys.stderr)
        return 2
    import torch
    ctx.mark('torch')
    # one process with few threads: the program's work is on the card,
    # and idle CPU worker threads only add noise to the host's timing
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = importlib.import_module('gcmbench.drivers.'
                                     + ctx.cell['driver'])
    ctx.mark('harness')
    result = driver.run(ctx)
    e2e_names = [m['name'] for m in bench['end_to_end']
                 if name in m.get('workloads', [name])]
    if trace:
        result.record['e2e_names'] = e2e_names
        metrics = per_layer(bench, name, result.record)
    else:
        metrics = {m['name']: {'value': result.e2e[m['name']],
                               'unit': m['unit']}
                   for m in bench['end_to_end'] if m['name'] in e2e_names}
    bad = forbidden_modules()
    if bad:
        print('gcmbench: the run loaded %s' % ', '.join(bad),
              file=sys.stderr)
        return 3
    print(setup_phases(ctx.t_start, ctx.marks), file=sys.stderr)
    for n, v, limit in result.checks:
        print('check %s: %.6g (limit %.6g) %s' % (
            n, v, limit, 'ok' if math.isfinite(v) and v <= limit
            else 'FAILED'), file=sys.stderr)
    sys.stderr.flush()
    print(result_line(result, metrics, trace))
    sys.stdout.flush()
    return 0
