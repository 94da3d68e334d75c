"""Megabytes the SL transport's four-corner gathers move per step of the
window: the program's counter ``SLAdvection.gather_bytes`` (n values
read, n int64 indices read and n values written a gather of n points),
read before and after the window.  None where the program has no such
counter."""


def read(record):
    counted = record.get('sl_gather_bytes')
    if counted is None or not record.get('steps'):
        return None
    return counted / record['steps'] / 1e6
