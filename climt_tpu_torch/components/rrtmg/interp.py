"""Table-row interpolation primitives (climt_tpu/components/rrtmg/interp.py).

Every correlated-k interpolation is a weighted sum of table rows,
``out = sum_t w_t * table[idx_t]``.  The JAX module evaluates it as a
one-hot MXU contraction (f32) or sequential gathers (f64); here both
``mix_rows`` (:29) and ``lin_rows`` (:117) are a direct gather through
kernel B (``fused_mix.mix_rows``).  ``mix_rows_windowed`` (:66) has no
counterpart: its per-level window exists only to shrink the MXU
contraction, and the full gather computes the same sum without dropping
out-of-window terms.
"""

from __future__ import annotations

import torch

from .fused_mix import mix_rows as _gather_sum


def mix_rows(table, terms):
    """sum_t w_t * table[clip(idx_t)] over (idx, w) pairs of shape S.

    Returns (*S, ng) in the weights' dtype."""
    terms = list(terms)
    idx = torch.stack([i for i, _ in terms])
    w = torch.stack([wt for _, wt in terms])
    return _gather_sum(table.to(w.dtype), idx, w)


def lin_rows(table, idx, frac, weight=None):
    """weight * (table[idx] + frac * (table[idx+1] - table[idx])) as the
    two-term gather-sum weight*(1-frac) on row idx, weight*frac on idx+1."""
    w_hi = frac if weight is None else weight * frac
    w_lo = (1.0 - frac) if weight is None else weight * (1.0 - frac)
    return mix_rows(table, [(idx, w_lo), (idx + 1, w_hi)])
