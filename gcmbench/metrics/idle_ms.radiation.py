"""Ms per profiled step in which the card ran no operation while the
radiation's spans (``climt.radiation``, ``.gas_optics``, ``.lw_sweep``,
``.sw_solver``) covered the host innermost (``gcmbench/spans.py``)."""

from gcmbench import spans


def read(record):
    return spans.layer_ms(record, 'radiation', idle=True)
