"""The plain reference of the benchmark: the moist GCM's step and its
RRTMG calls in plain PyTorch, frozen here so that no change to the
program moves the yardstick.  It imports nothing of the program and no
JAX; it reads the RRTMG tables and the ozone profile by path.

``matmul_precision`` sets the precision of float32 matrix products for
a block: 'float32' (TF32 off, the reference), or 'tf32' (the control
run in the next precision below)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def matmul_precision(mode):
    """Run the block with TF32 off ('float32') or on ('tf32') for float32
    matrix products and convolutions, and restore the settings after."""
    if mode not in ('float32', 'tf32'):
        raise ValueError('matmul precision %r: float32 or tf32' % (mode,))
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = mode == 'tf32'
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
