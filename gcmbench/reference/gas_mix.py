"""The table-row gather-sum of the RRTMG gas optics in plain PyTorch:
every term of every band of one output, summed band by band."""

from __future__ import annotations

import numpy as np
import torch


def _padded(ng):
    return -(-ng // 4) * 4


class Layout:
    """The packed tables and descriptors of one group of bands.

    ``parts`` is a list of (band, table, nterms); ``table`` is a (rows, ng)
    array or tensor, or a (ng,) row or a scalar for a one-row table."""

    def __init__(self, ngs, parts, dtype, device):
        flat, bands, terms = [], [], []
        off = t = goff = 0
        for b, ng in enumerate(ngs):
            ngp = _padded(ng)
            t0, tab0 = t, off
            for pb, table, n in parts:
                if pb != b:
                    continue
                tab = torch.as_tensor(table, dtype=dtype, device=device)
                tab = tab.expand(ng) if tab.dim() < 2 else tab
                tab = torch.nn.functional.pad(tab.reshape(-1, ng),
                                              (0, ngp - ng))
                flat.append(tab.reshape(-1))
                terms += [(off, tab.shape[0])] * n
                off += tab.numel()
                t += n
            bands.append((ng, ngp, t0, t - t0, goff, tab0, off - tab0))
            goff += ng
        self.width = goff
        self.nterms = t
        self.bands = bands
        self.terms = terms
        self.table = torch.cat(flat) if flat else torch.zeros(
            4, dtype=dtype, device=device)
        self.term_i64 = torch.as_tensor(
            np.asarray(terms, np.int64).reshape(-1, 2), device=device)


def mix_groups_plain(layout, idx, w):
    """Plain PyTorch version, one band at a time.  idx (T, *S) integer,
    w (T, *S) float; returns (*S, width) in w's dtype."""
    cells = tuple(idx.shape[1:])
    out = torch.zeros(cells + (layout.width,), dtype=w.dtype,
                      device=w.device)
    term = layout.term_i64
    for ng, ngp, t0, nt, goff, _, _ in layout.bands:
        if nt == 0:
            continue
        shape = (nt,) + (1,) * len(cells)
        base = term[t0:t0 + nt, 0].view(shape)
        rows = term[t0:t0 + nt, 1].view(shape)
        r = torch.minimum(idx[t0:t0 + nt].long().clamp(min=0), rows - 1)
        pos = (base + r * ngp)[..., None] + torch.arange(ng, device=w.device)
        out[..., goff:goff + ng] = (w[t0:t0 + nt, ..., None]
                                    * layout.table[pos]).sum(0)
    return out


class Group:
    """The terms of one output, written in place: a caller opens each
    band with ``band(ng)``, each part of it with ``part(table)``, and
    writes the part's terms through ``slot()``, ``lin`` or ``row``;
    ``run()`` packs the tables and evaluates the gather-sum."""

    def __init__(self, key, cells, dtype, device, source=None):
        self.cells = tuple(cells)
        self.dtype, self.device = dtype, device
        self.ngs, self.parts, self.terms = [], [], []

    def band(self, ng):
        self.ngs.append(ng)

    def part(self, table):
        self.parts.append([len(self.ngs) - 1, table, 0])

    def slot(self):
        """(index, weight) tensors of the next term of the current part."""
        self.parts[-1][2] += 1
        pair = (torch.zeros(self.cells, dtype=torch.int32,
                            device=self.device),
                torch.empty(self.cells, dtype=self.dtype,
                            device=self.device))
        self.terms.append(pair)
        return pair

    def lin(self, idx, frac, weight=None):
        """weight * (row[idx] + frac * (row[idx+1] - row[idx])) as the two
        terms weight*(1-frac) on idx and weight*frac on idx+1; weight is a
        tensor, a number or None (1)."""
        i_lo, w_lo = self.slot()
        i_hi, w_hi = self.slot()
        i_lo.copy_(idx)
        torch.add(idx, 1, out=i_hi)
        if weight is None:
            w_hi.copy_(frac)
            torch.sub(1.0, frac, out=w_lo)
        else:
            torch.mul(frac, weight, out=w_hi)
            torch.mul(1.0 - frac, weight, out=w_lo)

    def row(self, weight):
        """A one-row part's term."""
        w = self.slot()[1]
        if isinstance(weight, torch.Tensor):
            w.copy_(weight)
        else:
            w.fill_(weight)

    def run(self):
        """(*cells, width): every band's sum of its terms."""
        layout = Layout(self.ngs, self.parts, self.dtype, self.device)
        shape = (0,) + self.cells
        idx = (torch.stack([i for i, _ in self.terms]) if self.terms
               else torch.empty(shape, dtype=torch.int32, device=self.device))
        w = (torch.stack([w for _, w in self.terms]) if self.terms
             else torch.empty(shape, dtype=self.dtype, device=self.device))
        return mix_groups_plain(layout, idx, w)
