"""Ms per profiled step in which the card ran no operation while the
dynamics' spans (``climt.dynamics``, ``climt.fixer``,
``climt.collective``) covered the host innermost (``gcmbench/spans.py``)."""

from gcmbench import spans


def read(record):
    return spans.layer_ms(record, 'dynamics', idle=True)
