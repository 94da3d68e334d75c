"""The program's spans in a traced run, each instant put down to one
layer.  The program opens its spans (``climt.*``) through
``climt_tpu_torch.utils.profiling.phase``; they land among the host
operations of a ``tracing.Trace``, on the device trace's clock, and nest
properly on the one host thread.

Each instant of the profiled window goes to the innermost span covering
it, the one with the latest start.  A layer's host time is the measure
of the instants given to its spans (a span's length less what its child
spans cover: its self time); its idle time is the same measure taken
over the device's idle intervals alone (``Trace.gaps()``).  Both are per
profiled step (``trace_steps``) or call (``trace_calls``), in ms."""

from __future__ import annotations

PREFIX = 'climt.'

# the spans of each layer that a metric reads
LAYERS = {
    'radiation': ('climt.radiation', 'climt.gas_optics', 'climt.lw_sweep',
                  'climt.sw_solver'),
    'physics': ('climt.physics', 'climt.convection'),
    'dynamics': ('climt.dynamics', 'climt.fixer', 'climt.collective'),
    'transport': ('climt.transport',),
    'sw_solver': ('climt.sw_solver',),
}


def program_spans(trace):
    """(name, start s, end s) of the trace's program spans, by start (an
    outer span before an inner one that starts with it)."""
    return sorted((op for op in trace.host_ops if op[0].startswith(PREFIX)),
                  key=lambda op: (op[1], -op[2]))


def innermost(spans):
    """[(start s, end s, name)]: the pieces of the spans' union, each
    given to the innermost span covering it (the latest start)."""
    cuts = sorted({t for _, s, e in spans for t in (s, e)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        best = None
        for name, s, e in spans:
            if s > a:
                break
            if e >= b and (best is None or s >= best[1]):
                best = (name, s)
        if best is not None:
            out.append((a, b, best[0]))
    return out


def overlap(pieces, intervals):
    """{name: seconds of its pieces that fall inside ``intervals``}; both
    lists sorted by start, the intervals disjoint."""
    out, i = {}, 0
    for a, b, name in pieces:
        while i < len(intervals) and intervals[i][1] <= a:
            i += 1
        j = i
        while j < len(intervals) and intervals[j][0] < b:
            s, e = intervals[j]
            out[name] = out.get(name, 0.0) + min(b, e) - max(a, s)
            j += 1
    return out


def self_seconds(trace):
    """({span: host s}, {span: idle s}) of the whole profiled window."""
    pieces = innermost(program_spans(trace))
    host = {}
    for a, b, name in pieces:
        host[name] = host.get(name, 0.0) + b - a
    return host, overlap(pieces, trace.gaps())


def layer_ms(record, layer, idle=False):
    """A layer's host (or, with ``idle``, idle) ms per profiled step or
    call; None without a trace or where the trace holds none of its
    spans."""
    trace = record.get('trace')
    per = record.get('trace_steps') or record.get('trace_calls')
    if trace is None or not per:
        return None
    names = LAYERS[layer]
    if not any(op[0] in names for op in trace.host_ops):
        return None
    seconds = self_seconds(trace)[1 if idle else 0]
    return 1e3 * sum(seconds.get(n, 0.0) for n in names) / per
