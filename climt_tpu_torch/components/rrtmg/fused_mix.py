"""Table-row gather-sum for the RRTMG gas optics: kernel B and its plain
version.

    out[s, :] = sum_t w[t, s] * table[clip(idx[t, s], 0, R-1), :]

TPU kernel replaced: climt_tpu/components/rrtmg/fused_mix.py:76
(``fused_mix_rows``, Pallas body ``_mix_kernel`` :54).  On the TPU the
gather is rebuilt as one-hot rows contracted on the MXU, because TPU
gathers do not vectorise (interp.py:13-20); the JAX main path computes
the same function as that contraction in ``interp.mix_rows`` /
``mix_rows_windowed``.  On Hopper the gather is the natural form, and
every taumol interpolation of the port (LW and SW: key species,
continua, minor gases, Planck fractions, solar source) goes through it.

Bound on the card: bytes.  The tables (<= ~1.8k rows x <= 16 floats)
stay in L1/L2; each cell streams T int32 indices, T weights and ng
outputs.  ``csrc/mix_rows.cu`` runs one thread per (cell, g) with g
fastest, so stores are coalesced and the table goes through the
read-only cache; no (cells x rows) weight matrix exists anywhere.

Indices are clipped to [0, R-1], the semantics of ``interp.mix_rows``
(:45, :51), the function this replaces on the main path.  (The Pallas
kernel drops out-of-range rows only to handle its own tile padding.)
"""

from __future__ import annotations

import math

import torch

from ... import _build


def mix_rows_plain(table, idx, w):
    """Plain PyTorch version: (w[..., None] * table[clip(idx)]).sum(0)."""
    rows = table.shape[0]
    return (w[..., None] * table[idx.clamp(0, rows - 1)]).sum(0)


def mix_rows_cuda(table, idx, w):
    """Launch kernel B.  table (R, ng) f32, idx (T, *S) int32, w (T, *S)
    f32, all contiguous on one CUDA device.  Returns (*S, ng) f32."""
    if not (table.is_cuda and idx.device == table.device
            and w.device == table.device):
        raise ValueError('mix_rows_cuda: all tensors must be on one CUDA '
                         'device')
    if table.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError('mix_rows_cuda takes float32 table and weights, '
                        'got %s, %s' % (table.dtype, w.dtype))
    if idx.dtype != torch.int32:
        raise TypeError('mix_rows_cuda takes int32 indices, got %s'
                        % idx.dtype)
    if table.dim() != 2 or idx.dim() < 1 or idx.shape != w.shape:
        raise ValueError('mix_rows_cuda: shapes table %s, idx %s, w %s' % (
            tuple(table.shape), tuple(idx.shape), tuple(w.shape)))
    if not (table.is_contiguous() and idx.is_contiguous()
            and w.is_contiguous()):
        raise ValueError('mix_rows_cuda takes contiguous tensors')
    rows, ng = table.shape
    nterms = idx.shape[0]
    s_shape = tuple(idx.shape[1:])
    ncell = math.prod(s_shape)
    out = torch.empty(s_shape + (ng,), dtype=torch.float32,
                      device=table.device)
    lib = _build.library()
    rc = lib.climt_mix_rows_f32(
        table.data_ptr(), rows, ng, idx.data_ptr(), w.data_ptr(), nterms,
        ncell, out.data_ptr(), torch.cuda.current_stream(
            table.device).cuda_stream)
    _build.check_launch(rc, 'mix_rows_cuda')
    mix_rows_cuda.launches += 1
    return out


mix_rows_cuda.launches = 0


def mix_rows(table, idx, w):
    """sum_t w[t] * table[clip(idx[t])]: the plain version for CPU
    tensors, kernel B for CUDA tensors (which must be float32)."""
    if table.device.type == 'cpu':
        return mix_rows_plain(table, idx, w)
    return mix_rows_cuda(table.contiguous(), idx.to(torch.int32).contiguous(),
                         w.contiguous())
