"""The comparison that decides ``correct``: the program's outputs against
the plain reference's, field by field.

For a nest of dicts and tuples of tensors (a model carry and its
diagnostics, or a radiation call's fluxes) two numbers are taken over
every field: ``l2``, the largest ||program - reference|| / ||reference||,
and ``max``, the largest max|program - reference| / max|reference|.
Complex fields compare as their real and imaginary parts.  A field that
is not finite in the program reads inf.  Integers in the nest (the step
index) must be equal, or both numbers read inf.
"""

from __future__ import annotations

import math

import torch


def flatten(tree, prefix=''):
    """{path: leaf} of the tensors and integers of a nest of dicts,
    tuples and lists."""
    out = {}
    if isinstance(tree, dict):
        for key in sorted(tree):
            out.update(flatten(tree[key], '%s/%s' % (prefix, key)))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            out.update(flatten(x, '%s/%d' % (prefix, i)))
    elif torch.is_tensor(tree) or isinstance(tree, int):
        out[prefix or '/'] = tree
    return out


def _real(x):
    x = x.detach()
    if x.is_complex():
        x = torch.view_as_real(x)
    return x.double()


def field_gaps(program, reference):
    """{path: (l2, max)} of every field of the two nests."""
    p, r = flatten(program), flatten(reference)
    if p.keys() != r.keys():
        missing = sorted(set(p) ^ set(r))
        return {'fields ' + ','.join(missing[:4]): (math.inf, math.inf)}
    out = {}
    for key in p:
        a, b = p[key], r[key]
        if not torch.is_tensor(a) or not torch.is_tensor(b):
            out[key] = (0.0, 0.0) if a == b else (math.inf, math.inf)
            continue
        if a.shape != b.shape:
            out[key] = (math.inf, math.inf)
            continue
        a = _real(a).to(b.device)
        b = _real(b)
        if not bool(torch.isfinite(a).all()):
            out[key] = (math.inf, math.inf)
            continue
        diff = a - b
        norm = float(torch.linalg.vector_norm(b))
        peak = float(b.abs().max()) if b.numel() else 0.0
        dn = float(torch.linalg.vector_norm(diff))
        dm = float(diff.abs().max()) if diff.numel() else 0.0
        out[key] = (dn / norm if norm > 0 else (0.0 if dn == 0 else
                                                math.inf),
                    dm / peak if peak > 0 else (0.0 if dm == 0 else
                                                math.inf))
    return out


def gaps(program, reference, max_over=None):
    """(l2, max, field of the larger l2) over every field; ``max`` only
    over the fields for which ``max_over(path)`` is true, when given."""
    per = field_gaps(program, reference)
    l2 = max(v[0] for v in per.values())
    mx = max((v[1] for k, v in per.items()
              if max_over is None or max_over(k)), default=0.0)
    worst = max(per, key=lambda k: per[k][0])
    return l2, mx, worst
