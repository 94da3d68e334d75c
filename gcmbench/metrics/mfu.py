"""The program's share of its cards' float32 peak over the traced window,
in per cent: the operations that ``costs`` counts for the window's work
(``window_flops``: ``costs.gcm.cycle_flops`` a radiation cycle,
``costs.rrtmg.call_flops`` an LW+SW call), over the window's seconds
times the published 67 TFLOP/s (TF32 off) of each of its ``chips``.
One reader for every cell: ``mfu.<cell kind>`` names it."""

from gcmbench.costs import peaks


def read(record):
    if not record.get('window_flops') or not record.get('window_s'):
        return None
    return 100.0 * record['window_flops'] / (
        record['window_s'] * record.get('chips', 1)
        * peaks.FP32_FLOPS_PER_S)
