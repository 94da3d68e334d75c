"""Host ms per profiled step that the FV transport's span
(``climt.transport``) covers innermost: its self time
(``gcmbench/spans.py``)."""

from gcmbench import spans


def read(record):
    return spans.layer_ms(record, 'transport')
