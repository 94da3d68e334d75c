"""Host ms per profiled step that the column physics' spans
(``climt.physics``, ``climt.convection``) cover innermost: their self
time (``gcmbench/spans.py``)."""

from gcmbench import spans


def read(record):
    return spans.layer_ms(record, 'physics')
