"""Milliseconds of a plain step (one that reuses the stored heating
rates) of the moist GCM: host clock around each cycle's plain steps
together, a synchronize after them, over all plain steps of the traced
window."""


def read(record):
    if not record.get('plain_steps'):
        return None
    return 1e3 * sum(record['plain_s']) / record['plain_steps']
