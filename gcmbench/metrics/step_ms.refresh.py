"""Milliseconds of a radiation refresh step of the moist GCM: host clock
around each refresh step of the traced window, a synchronize after it,
the mean over the window."""


def read(record):
    times = record.get('refresh_s')
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
