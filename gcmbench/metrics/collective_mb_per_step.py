"""Megabytes rank 0 hands to the program's collectives per step of the
window: the program's own counters (``dist_sht.transpose.bytes``,
``halo.LatHalo.bytes``, ``rep_sht.all_reduce_sum.bytes``,
``rep_sht.all_gather_cat.bytes``), read before and after the window."""


def read(record):
    counted = record.get('collective_bytes')
    if counted is None or not record.get('steps'):
        return None
    return sum(counted.values()) / record['steps'] / 1e6
