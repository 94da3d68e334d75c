"""Share of rank 0's device time in the profiled cycle that NCCL's
kernels take, in per cent: the kernels whose name begins with ``nccl``
over all of its kernels.  It holds the time they wait for the slowest
rank."""


def read(record):
    trace = record.get('trace')
    if trace is None:
        return None
    kernels = trace.kernels()
    total = sum(e - s for _, s, e in kernels)
    if total <= 0:
        return None
    nccl = sum(e - s for name, s, e in kernels if name.startswith('nccl'))
    return 100.0 * nccl / total
