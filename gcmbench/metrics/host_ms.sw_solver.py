"""Host ms per profiled LW+SW call that the SW solver's span
(``climt.sw_solver``) covers innermost: its self time
(``gcmbench/spans.py``)."""

from gcmbench import spans


def read(record):
    return spans.layer_ms(record, 'sw_solver')
