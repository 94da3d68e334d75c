"""Host ms per profiled step that the radiation's spans (``climt.radiation``,
``.gas_optics``, ``.lw_sweep``, ``.sw_solver``) cover innermost: their
self time (``gcmbench/spans.py``)."""

from gcmbench import spans


def read(record):
    return spans.layer_ms(record, 'radiation')
