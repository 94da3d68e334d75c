"""Milliseconds of an RRTMG SW call on a whole slice of columns: host
clock around each SW call of the traced window, a synchronize before
and after it, the mean over the window."""


def read(record):
    times = record.get('sw_s')
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
