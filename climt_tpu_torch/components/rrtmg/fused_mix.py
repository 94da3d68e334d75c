"""Band-fused table-row gather-sum for the RRTMG gas optics: kernel B
and its plain version.

One launch computes one taumol output for every band at once.  Band b
owns the output columns [goff_b, goff_b + ng_b) and the terms
[t0_b, t0_b + nt_b); for every cell s

    out[s, goff_b + g] = sum_t  w[t, s] * table_t[clip(idx[t, s], 0, R_t - 1), g]

where table_t is the part (key species [absa; absb], selfref, forref, a
minor-gas k-table, a one-row cross-section, ...) that term t reads.  The
terms of a band are summed in the working type, float32 or float64, in
term order.

TPU kernel replaced: climt_tpu/components/rrtmg/fused_mix.py:76
(``fused_mix_rows``, Pallas body ``_mix_kernel`` :54), at the granularity
``BandAccum`` (:130) gives it there: every term of every part of a band,
all tables concatenated row-wise, in one kernel.  The port goes one step
further and puts all bands of one output (LW taug, LW fracs, SW taug, SW
taur, SW solar source, the LW Planck functions) into one launch, so a
radiation call of one column chunk makes 6 launches of kernel B.

Bound on the card: bytes.  Each term streams one weight (4 bytes in
float32, 8 in float64) and, when its table has more than one row, 4 bytes
of index per cell; the output is written once; the packed tables (at most
116 KB per band in float32) stay in L1/L2.  ``csrc/mix_rows.cu`` runs one
thread per cell and one block per (band, 128-cell tile), the band fastest
so that the blocks writing one tile's output rows run together: the thread
loads each term's index and weight once (coalesced along cells), reads
table rows 16 bytes at a time, keeps the ng sums in registers and stages
its row through shared memory so that the block writes the band's slice
of the output in contiguous runs.  The kernel is one template with a
float32 and a float64 instantiation: the fused moist GCM runs in float32,
the climt components (``RRTMGLongwave``, ``RRTMGShortwave``) at their
state's float64.

Layout (``Layout``): packed once and cached, one per output, dtype and
device; a group whose tables come from another
source than the cached layout's (new LW k-tables installed, or passed with
``tables=``) packs again and replaces it.  Every part's table is padded to
a multiple of 4 elements per row and packed band by band into one flat
buffer; each band has a descriptor (ng, padded ng, first term, term
count, output offset, table offset and length) and each term one (flat
offset of its part's row 0, its part's row count).
Callers write raw, part-relative row indices and their weights straight
into one preallocated (terms, *cells) int32 and float pair (``Group``);
the kernel clips and offsets the index itself, and reads no index at all
for a one-row table.

Gradient (``MixGroups``): the LW k-table calibration differentiates the
fluxes with respect to the tables.  ``Layout`` packs with ``pad`` and
``cat``, so ``Layout.table`` carries the graph back to the tables it was
packed from; on the card ``mix_groups`` then runs kernel B under an
``autograd.Function`` whose backward is ``csrc/mix_rows_bwd.cu``,

    dtable[base_t + clip(idx[t, s]) * ngp + g] += w[t, s] * gout[s, goff + g],

with ``mix_groups_bwd_plain`` beside it.  It replaces XLA's autodiff of
the float64 gather of climt_tpu/components/rrtmg/interp.py:45, which is
where JAX takes this gradient (the path ``fused_mix._pallas_mode() ==
'off'`` selects; its Pallas kernel has no gradient).  Bound on the card:
bytes, each weight and multi-row index read once, ``gout`` read once and
the table gradient written once.  What limits a scatter of this kind is
contention: the cells of one level pick the same few rows of each term's
table.  The kernel's answers: a lane owns 16 bytes of consecutive cells
and sums w * gout over those that share a row in registers; a warp
meets once per row of its tile and reduces the ng sums with one
transposing reduce-scatter, after which ng lanes add them with one
atomic instruction; the band's padded width is a template parameter, so
the sums stay in registers; each warp tile's slice of ``gout`` is read
coalesced and transposed through shared memory.  The grid is (band,
run of 512 cells), bands fastest, so the blocks of every band on one run
go out together and read its ``gout`` from L2.  The weights never carry
a graph (taumol's term writers refuse fields that require grad, setcoef's
Planck group writes with ``out=``), and a weight that requires grad is
refused on the card.  A layout packed from tables that
require grad is never cached: each call packs afresh, so one step's graph
is never handed to another.  On the CPU the plain version is
differentiated by autograd itself.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ... import _build

def _padded(ng):
    return -(-ng // 4) * 4


def _signature(ngs, parts):
    return tuple(ngs), tuple((b, np.shape(tab), n) for b, tab, n in parts)


def _requires_grad(tables):
    """Whether any of ``tables`` is a tensor that requires grad."""
    return any(torch.is_tensor(t) and t.requires_grad for t in tables)


class Layout:
    """The packed tables and descriptors of one group of bands.

    ``parts`` is a list of (band, table, nterms); ``table`` is a (rows, ng)
    array or tensor, or a (ng,) row or a scalar for a one-row table.
    ``source`` is the object the tables were taken from (``Group``'s)."""

    def __init__(self, ngs, parts, dtype, device, source=None):
        self.signature = _signature(ngs, parts)
        self.source = source
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
        i32 = dict(dtype=torch.int32, device=device)
        self.band_desc = torch.as_tensor(
            np.asarray(bands, np.int32).reshape(-1), **i32)
        self.term_desc = torch.as_tensor(
            np.asarray(terms, np.int32).reshape(-1), **i32)
        self.term_i64 = self.term_desc.long().reshape(-1, 2)

    @classmethod
    def single(cls, table, nterms):
        """One band, one part: the layout of ``mix_rows``."""
        return cls([table.shape[1]], [(0, table, nterms)], table.dtype,
                   table.device)


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


_ENTRY = {torch.float32: 'climt_mix_groups_f32',
          torch.float64: 'climt_mix_groups_f64'}


def mix_groups_cuda(layout, idx, w):
    """Launch kernel B on one group.  idx (T, *S) int32 and w (T, *S)
    float32 or float64 (the layout's table type), contiguous, on the
    layout's CUDA device.  Returns (*S, width) in that type."""
    table = layout.table
    if not (table.is_cuda and idx.device == table.device
            and w.device == table.device):
        raise ValueError('mix_groups_cuda: all tensors must be on one CUDA '
                         'device')
    if table.dtype not in _ENTRY or w.dtype != table.dtype:
        raise TypeError('mix_groups_cuda takes float32 or float64 tables '
                        'and weights of one type, got %s, %s' % (
                            table.dtype, w.dtype))
    if idx.dtype != torch.int32:
        raise TypeError('mix_groups_cuda takes int32 indices, got %s'
                        % idx.dtype)
    if idx.shape != w.shape or idx.shape[0] != layout.nterms:
        raise ValueError('mix_groups_cuda: idx %s and w %s for %d terms' % (
            tuple(idx.shape), tuple(w.shape), layout.nterms))
    if not (idx.is_contiguous() and w.is_contiguous()):
        raise ValueError('mix_groups_cuda takes contiguous tensors')
    cells = tuple(idx.shape[1:])
    ncell = math.prod(cells)
    out = torch.empty(cells + (layout.width,), dtype=table.dtype,
                      device=table.device)
    if ncell == 0:
        return out
    rc = getattr(_build.library(), _ENTRY[table.dtype])(
        table.data_ptr(), layout.band_desc.data_ptr(), len(layout.bands),
        layout.term_desc.data_ptr(), idx.data_ptr(), w.data_ptr(), ncell,
        layout.width, out.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check_launch(rc, 'mix_groups_cuda')
    mix_groups_cuda.launches += 1
    return out


mix_groups_cuda.launches = 0


def mix_groups_bwd_plain(layout, idx, w, gout):
    """Plain PyTorch backward of ``mix_groups`` with respect to the packed
    table: the gradient of sum(gout * mix_groups(layout, idx, w)), a
    tensor like ``layout.table`` (its padding columns zero).  Each term's
    w * gout is added into its clipped, offset rows with
    ``index_put_(accumulate=True)``; a one-row part's term is summed over
    the cells first."""
    grad = torch.zeros(layout.table.shape, dtype=w.dtype, device=w.device)
    ncell = math.prod(idx.shape[1:])
    g_all = gout.reshape(ncell, layout.width)
    term = layout.term_i64
    for ng, ngp, t0, nt, goff, _, _ in layout.bands:
        if nt == 0:
            continue
        cols = torch.arange(ng, device=w.device)
        g = g_all[:, goff:goff + ng]
        wt = w[t0:t0 + nt].reshape(nt, ncell)
        base, rows = term[t0:t0 + nt, 0], term[t0:t0 + nt, 1]
        one = rows == 1
        if bool(one.any()):
            grad.index_put_(((base[one, None] + cols).reshape(-1),),
                            (wt[one] @ g).reshape(-1), accumulate=True)
        many = ~one
        if bool(many.any()):
            r = torch.minimum(idx[t0:t0 + nt].reshape(nt, ncell)[many]
                              .long().clamp(min=0), rows[many, None] - 1)
            pos = (base[many, None] + r * ngp)[..., None] + cols
            grad.index_put_((pos.reshape(-1),),
                            (wt[many, :, None] * g).reshape(-1),
                            accumulate=True)
    return grad


_BWD_ENTRY = {torch.float32: 'climt_mix_groups_bwd_f32',
              torch.float64: 'climt_mix_groups_bwd_f64'}


def mix_groups_bwd_cuda(layout, idx, w, gout):
    """Launch kernel B's backward (``csrc/mix_rows_bwd.cu``): the gradient
    of sum(gout * mix_groups(layout, idx, w)) with respect to the packed
    table, as ``mix_groups_bwd_plain``.  idx, w as ``mix_groups_cuda``
    takes them; gout (*S, width) contiguous, in w's type."""
    table = layout.table
    if not all(x.is_cuda and x.device == table.device
               for x in (idx, w, gout)):
        raise ValueError('mix_groups_bwd_cuda: all tensors must be on one '
                         'CUDA device')
    if w.dtype not in _BWD_ENTRY or gout.dtype != w.dtype \
            or table.dtype != w.dtype:
        raise TypeError('mix_groups_bwd_cuda takes float32 or float64 '
                        'tables, weights and gradients of one type, got '
                        '%s, %s, %s' % (table.dtype, w.dtype, gout.dtype))
    if idx.dtype != torch.int32:
        raise TypeError('mix_groups_bwd_cuda takes int32 indices, got %s'
                        % idx.dtype)
    cells = tuple(idx.shape[1:])
    if (idx.shape != w.shape or idx.shape[0] != layout.nterms
            or tuple(gout.shape) != cells + (layout.width,)):
        raise ValueError('mix_groups_bwd_cuda: idx %s, w %s, gout %s for %d '
                         'terms of width %d' % (
                             tuple(idx.shape), tuple(w.shape),
                             tuple(gout.shape), layout.nterms, layout.width))
    if not (idx.is_contiguous() and w.is_contiguous()
            and gout.is_contiguous()):
        raise ValueError('mix_groups_bwd_cuda takes contiguous tensors')
    if any(b[0] > 16 for b in layout.bands):
        raise ValueError('mix_groups_bwd_cuda takes bands of at most 16 '
                         'g-points')
    grad = torch.zeros(table.shape, dtype=w.dtype, device=table.device)
    ncell = math.prod(cells)
    if ncell == 0 or layout.nterms == 0:
        return grad
    rc = getattr(_build.library(), _BWD_ENTRY[w.dtype])(
        layout.band_desc.data_ptr(), len(layout.bands),
        layout.term_desc.data_ptr(), idx.data_ptr(), w.data_ptr(), ncell,
        layout.width, gout.data_ptr(), grad.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check_launch(rc, 'mix_groups_bwd_cuda')
    mix_groups_bwd_cuda.launches += 1
    return grad


mix_groups_bwd_cuda.launches = 0


class MixGroups(torch.autograd.Function):
    """Kernel B under autograd on the card: ``mix_groups_cuda`` forward,
    ``mix_groups_bwd_cuda`` backward, differentiable in the packed table
    (the first argument, ``layout.table``) only."""

    @staticmethod
    def forward(ctx, table, layout, idx, w):
        ctx.layout = layout
        ctx.save_for_backward(idx, w)
        return mix_groups_cuda(layout, idx, w)

    @staticmethod
    def backward(ctx, gout):
        idx, w = ctx.saved_tensors
        return (mix_groups_bwd_cuda(ctx.layout, idx, w, gout.contiguous()),
                None, None, None)


def mix_groups(layout, idx, w):
    """The plain version for CPU tensors (autograd follows it), kernel B
    for CUDA tensors.  On the card, with grad mode on, a packed table that
    requires grad runs through ``MixGroups`` (kernel B and its backward
    kernel), and weights that require grad raise: kernel B has no
    gradient for them."""
    if w.device.type == 'cpu':
        return mix_groups_plain(layout, idx, w)
    if torch.is_grad_enabled():
        if w.requires_grad:
            raise NotImplementedError(
                'kernel B (mix_groups_cuda) has no gradient for its '
                'weights: w requires grad')
        if layout.table.requires_grad:
            return MixGroups.apply(layout.table, layout, idx, w)
    return mix_groups_cuda(layout, idx, w)


class Group:
    """The terms of one output, written in place for one launch.

    taumol's groups declare every band and part at once with ``declare``
    and ``term_writer.taumol_terms`` writes their terms; setcoef's Planck
    group opens its band with ``band(ng)``, its part with ``part(table)``
    and writes the part's terms through ``lin`` (or ``slot()``, an index
    and a weight view to fill with ``out=``).  ``run()`` launches.  The
    packed layout is cached under ``key``, with ``source``, the object the
    caller takes its tables from (the LW k-table dict; None for fixed
    tables): on the first call, or when the cached layout was packed from
    another source, the terms are collected
    and the tables packed, replacing the cached layout; later calls from
    the same source write into one preallocated (terms, *cells) pair and
    must produce the same bands, parts and term counts.  The source is
    compared by identity and the layout keeps a reference to it, so a
    dict installed later is never taken for an earlier one.  Tables that
    require grad are packed on every call and never cached: a packed
    table carries the graph of the call that packed it."""

    _LAYOUTS = {}

    def __init__(self, key, cells, dtype, device, source=None):
        self.key = (key, dtype, str(torch.device(device)))
        self.cells = tuple(cells)
        self.dtype, self.device = dtype, device
        self.source = source
        self.layout = self._LAYOUTS.get(self.key)
        if self.layout is not None and self.layout.source is not source:
            self.layout = None
        self.ngs, self.parts, self.fresh = [], [], []
        self.nterms = 0
        if self.layout is not None:
            shape = (self.layout.nterms,) + self.cells
            self.idx = torch.empty(shape, dtype=torch.int32, device=device)
            self.w = torch.empty(shape, dtype=dtype, device=device)

    def band(self, ng):
        self.ngs.append(ng)

    def declare(self, ngs, parts):
        """Every band and part at once, the parts' terms written elsewhere
        (by ``term_writer.taumol_terms``):
        ``ngs`` the bands' widths, ``parts`` (band, table, nterms) in term
        order.  ``finish()`` then allocates the (terms, *cells) pair
        unwritten."""
        self.ngs = list(ngs)
        self.parts = [list(p) for p in parts]
        self.nterms = sum(p[2] for p in parts)

    def part(self, table):
        self.parts.append([len(self.ngs) - 1, table, 0])

    def slot(self):
        """(index, weight) views of the next term of the current part."""
        self.parts[-1][2] += 1
        t = self.nterms
        self.nterms += 1
        if self.layout is not None:
            if t >= self.layout.nterms:
                raise RuntimeError('group %s: more terms than its cached '
                                   'layout' % (self.key,))
            return self.idx[t], self.w[t]
        pair = (torch.zeros(self.cells, dtype=torch.int32,
                            device=self.device),
                torch.empty(self.cells, dtype=self.dtype,
                            device=self.device))
        self.fresh.append(pair)
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

    def finish(self):
        """(layout, idx, w) of the written terms, packing the tables on
        the first call for this key and source."""
        if self.layout is None:
            self.layout = Layout(self.ngs, self.parts, self.dtype,
                                 self.device, self.source)
            if not _requires_grad(tab for _, tab, _ in self.parts):
                self._LAYOUTS[self.key] = self.layout
            shape = (self.layout.nterms,) + self.cells
            self.idx = (torch.stack([i for i, _ in self.fresh]) if self.fresh
                        else torch.empty(shape, dtype=torch.int32,
                                         device=self.device))
            self.w = (torch.stack([w for _, w in self.fresh]) if self.fresh
                      else torch.empty(shape, dtype=self.dtype,
                                       device=self.device))
            self.fresh = []
        elif _signature(self.ngs, self.parts) != self.layout.signature:
            raise RuntimeError('group %s: terms differ from its cached '
                               'layout' % (self.key,))
        return self.layout, self.idx, self.w

    def run(self):
        """Launch (or, on the CPU, evaluate) the group: (*cells, width)."""
        return mix_groups(*self.finish())


# ---- the single-table entry point (one band, one part) ----------------

def mix_rows_plain(table, idx, w):
    """Plain PyTorch version: (w[..., None] * table[clip(idx)]).sum(0)."""
    rows = table.shape[0]
    return (w[..., None] * table[idx.clamp(0, rows - 1)]).sum(0)


def mix_rows_cuda(table, idx, w):
    """Kernel B on one table: table (R, ng) and w (T, *S) of one type,
    float32 or float64, idx (T, *S) int32, all contiguous on one CUDA
    device.  Returns (*S, ng)."""
    if not (table.is_cuda and idx.device == table.device
            and w.device == table.device):
        raise ValueError('mix_rows_cuda: all tensors must be on one CUDA '
                         'device')
    if table.dim() != 2 or idx.dim() < 1 or idx.shape != w.shape:
        raise ValueError('mix_rows_cuda: shapes table %s, idx %s, w %s' % (
            tuple(table.shape), tuple(idx.shape), tuple(w.shape)))
    return mix_groups_cuda(Layout.single(table, idx.shape[0]), idx, w)


def mix_rows(table, idx, w):
    """sum_t w[t] * table[clip(idx[t])]: the plain version for CPU
    tensors, kernel B for CUDA tensors (float32 or float64)."""
    if table.device.type == 'cpu':
        return mix_rows_plain(table, idx, w)
    return mix_rows_cuda(table.contiguous(), idx.to(torch.int32).contiguous(),
                         w.contiguous())
