"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): HBM bandwidth and the float32
rate outside the tensor cores.  TF32 stays off in every cell, so the
float32 rate is the peak a float32 step can reach."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_seconds(nbytes, flops=0.0):
    """The least time the card could take to move ``nbytes`` and do
    ``flops`` float32 operations: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
