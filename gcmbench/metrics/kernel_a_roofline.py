"""Kernel A's share of its roofline, in per cent: the least time the
card needs for the bytes, or the operations where they bound it more,
that ``costs.rrtmg`` counts for the profiled LW calls, over the summed
device time of the ``rtrn_lw_kernel`` launches in their trace."""

from gcmbench.costs import peaks


def read(record):
    trace, calls = record.get('trace'), record.get('trace_calls')
    if trace is None or not calls or 'kernel_a_bytes' not in record:
        return None
    busy = sum(e - s for _, s, e in trace.kernels('rtrn_lw_kernel'))
    if busy <= 0:
        return None
    bound = peaks.bound_seconds(calls * record['kernel_a_bytes'],
                                calls * record['kernel_a_flops'])
    return 100.0 * bound / busy
