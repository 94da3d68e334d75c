"""Milliseconds of an RRTMG LW call on a whole slice of columns: host
clock around each LW call of the traced window, a synchronize before
and after it, the mean over the window."""


def read(record):
    times = record.get('lw_s')
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
