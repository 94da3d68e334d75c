"""Ms per profiled step in which the card ran no operation while the
column physics' spans (``climt.physics``, ``climt.convection``) covered
the host innermost (``gcmbench/spans.py``)."""

from gcmbench import spans


def read(record):
    return spans.layer_ms(record, 'physics', idle=True)
