"""Share of the profiled window in which the card ran no operation, in
per cent: 1 - (union of the device operations' intervals) / (the
window's length on the host clock), from the device trace.  One reader
for every cell: ``idle_share.<cell kind>`` names it."""


def read(record):
    trace = record.get('trace')
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
