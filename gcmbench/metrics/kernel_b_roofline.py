"""Kernel B's share of its roofline, in per cent: the least time the
card needs for the bytes ``costs.rrtmg.kernel_b_bytes`` counts for the
profiled LW+SW calls, over the summed device time of the
``mix_groups_kernel`` launches in their trace."""

from gcmbench.costs import peaks


def read(record):
    trace, calls = record.get('trace'), record.get('trace_calls')
    if trace is None or not calls or 'kernel_b_bytes' not in record:
        return None
    busy = sum(e - s for _, s, e in trace.kernels('mix_groups_kernel'))
    if busy <= 0:
        return None
    bound = peaks.bound_seconds(calls * record['kernel_b_bytes'])
    return 100.0 * bound / busy
