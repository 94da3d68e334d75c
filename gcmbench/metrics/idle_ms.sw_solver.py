"""Ms per profiled LW+SW call in which the card ran no operation while the
SW solver's span (``climt.sw_solver``) covered the host innermost
(``gcmbench/spans.py``)."""

from gcmbench import spans


def read(record):
    return spans.layer_ms(record, 'sw_solver', idle=True)
