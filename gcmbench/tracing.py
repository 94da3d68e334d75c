"""The device trace of a traced run, reduced in memory: no trace file is
written.  ``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (the CPU
and the card) and returns a ``Trace``: the device operations' intervals
and names, the host operations' intervals, and the length of the traced
window on the host clock."""

from __future__ import annotations

import dataclasses
import time

import torch

SPAN = 'gcmbench.'
# host events that are the CUDA runtime's or the profiler's own, not the
# program's work
PROFILER_OWN = ('cuda', 'cu', 'Activity Buffer Request')


@dataclasses.dataclass
class Trace:
    """Device operations (name, start s, end s) and host operations
    (name, start s, end s) on one clock, and the traced window's
    seconds."""
    device_ops: list
    host_ops: list
    window_s: float

    def kernels(self, part=''):
        """Kernel launches (not copies or fills) whose name holds
        ``part``."""
        return [op for op in self.device_ops
                if part in op[0] and not op[0].startswith(('Memcpy',
                                                          'Memset'))]

    def busy_s(self):
        """Seconds in which some operation ran on the device: the union
        of the device operations' intervals."""
        busy, end = 0.0, None
        for _, s, e in sorted(self.device_ops, key=lambda op: op[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def gaps(self):
        """(start s, end s) of every interval in which no device operation
        ran, between the first and the last."""
        out, end = [], None
        for _, s, e in sorted(self.device_ops, key=lambda op: op[1]):
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return out

    def top_device_ops(self, n=10):
        """[name, seconds] of the n device operations that took most time,
        summed by name."""
        by_name = {}
        for name, s, e in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        return [[k[:200], v] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:n]]

    def longest_gaps(self, n=10):
        """[what the host was doing, seconds] of the n longest idle gaps
        of the device: the innermost host operation that covers the
        gap's middle, or 'host: no traced operation'."""
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        hosts = sorted(self.host_ops, key=lambda op: op[1])
        out = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inner = None
            for name, hs, he in hosts:
                if hs > mid:
                    break
                if he >= mid and (inner is None
                                  or he - hs < inner[2] - inner[1]):
                    inner = (name, hs, he)
            out.append([inner[0][:200] if inner else
                        'host: no traced operation', e - s])
        return out


def _seconds(event, which):
    ns = getattr(event, which + '_ns', None)
    if ns is not None:
        return ns() * 1e-9
    return getattr(event, which + '_us')() * 1e-6


def _annotation(ev):
    kind = str(ev.activity_type()).lower() if hasattr(
        ev, 'activity_type') else ''
    return ('annotation' in kind or ev.name().startswith(SPAN)
            or bool(getattr(ev, 'is_user_annotation', lambda: False)()))


def span(name):
    """A named span of the benchmark's own around a call into the
    program; it shows in the host operations of a ``Trace``."""
    return torch.profiler.record_function(SPAN + name)


def profiled(fn, device='cuda'):
    """(fn's result, Trace) of one call of ``fn`` on ``device`` (the card,
    or on the CPU the host alone), from a synchronized start to a
    synchronized end."""
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(device).type == 'cuda'
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window = time.perf_counter() - t0
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s, e = _seconds(ev, 'start'), _seconds(ev, 'end')
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            # the spans' marks on the device's timeline are no operations
            if not _annotation(ev):
                device.append((ev.name(), s, e))
        elif not ev.name().startswith(PROFILER_OWN):
            host.append((ev.name(), s, e))
    return out, Trace(device, host, window)
