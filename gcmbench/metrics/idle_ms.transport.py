"""Ms per profiled step in which the card ran no operation while the FV
transport's span (``climt.transport``) covered the host innermost
(``gcmbench/spans.py``)."""

from gcmbench import spans


def read(record):
    return spans.layer_ms(record, 'transport', idle=True)
