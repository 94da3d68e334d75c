"""Batched tridiagonal (Thomas) solver (climt_tpu/ops/tridiagonal.py).

JAX's two ``lax.scan`` sweeps are two Python loops over the leading
axis here, with the batch (column) axes vectorized; each step does JAX's
arithmetic in JAX's order, so both solves agree to roundoff.
"""

from __future__ import annotations

import torch


def tridiagonal_solve(lower, diag, upper, rhs):
    """Solve (lower, diag, upper) x = rhs along the LEADING axis (:16).

    lower[0] and upper[-1] are ignored; every argument is (n, ...) and the
    solve is batched over the trailing axes."""
    zeros = torch.zeros_like(diag[0])
    c_prev, d_prev = zeros, zeros
    c_prime, d_prime = [], []
    for a, b, c, d in zip(lower, diag, upper, rhs):
        denom = b - a * c_prev
        c_prev = c / denom
        d_prev = (d - a * d_prev) / denom
        c_prime.append(c_prev)
        d_prime.append(d_prev)
    x_next = zeros
    x = []
    for c, d in zip(reversed(c_prime), reversed(d_prime)):
        x_next = d - c * x_next
        x.append(x_next)
    return torch.stack(x[::-1])
