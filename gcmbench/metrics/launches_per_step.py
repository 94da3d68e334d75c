"""Kernel launches per model step: the kernels of the device trace of
one profiled radiation cycle (copies and fills not counted), divided by
its steps.  An exact count."""


def read(record):
    trace, steps = record.get('trace'), record.get('trace_steps')
    if trace is None or not steps:
        return None
    return len(trace.kernels()) / steps
