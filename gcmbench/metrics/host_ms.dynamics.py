"""Host ms per profiled step that the dynamics' spans (``climt.dynamics``,
``climt.fixer``, ``climt.collective``) cover innermost: their self time
(``gcmbench/spans.py``)."""

from gcmbench import spans


def read(record):
    return spans.layer_ms(record, 'dynamics')
