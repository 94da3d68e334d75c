"""Distributed spherical-harmonic transform: latitude-local FFT, an
all_to_all transpose, and m-local Legendre matmuls
(climt_tpu/parallel/dist_sht.py).

The grid is sharded over latitude bands on the mesh's 'lat' axis, so the
zonal FFT is local to a rank; the Legendre transform needs every latitude
of a zonal wavenumber m, so the Fourier coefficients are transposed with
one ``all_to_all_single`` per direction on the 'lat' process group.  After
it each rank owns one block of m and does its Legendre matmuls locally:
the spectral state is sharded over m.  M = truncation + 1 is padded to a
multiple of the 'lat' extent L; the padded rows carry no coefficients
(the triangular mask is zero there).

Layouts on the rank of 'lat' index i (of L):
  grid blocks      (..., nlat/L, nlon): rows i*nlat/L .. (i+1)*nlat/L - 1;
  spectral blocks  (..., m_block, N+1): m = i*m_block .. (i+1)*m_block - 1,
                   with m_block = M_padded / L.

Each rank holds only its own m-block of the Legendre tensors and of every
per-m constant, and its own rows of cos(latitude): ``m_block_of`` and
``rows`` are the one place these are cut.  Complex tensors cross the
collectives as ``torch.view_as_real`` views.  Every per-n implicit solve
and per-m product of the dycore is wavenumber-local, so only the
transforms communicate.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from ..ops.sht import DFT_BUFFERS, SphericalHarmonicTransform
from ..utils.profiling import phase
from .rep_sht import all_gather_cat, all_reduce_sum


def transpose(x, group):
    """all_to_all_single of a complex tensor over ``group``: chunk j of
    dim 0 goes to the group's rank j, and chunk j of the result came from
    it.  Counts its calls in ``transpose.calls`` and the bytes it hands to
    the collective (the rank's own chunk included) in
    ``transpose.bytes``."""
    with phase('climt.collective'):
        xr = torch.view_as_real(x.contiguous())
        out = torch.empty_like(xr)
        dist.all_to_all_single(out, xr, group=group)
        transpose.calls += 1
        transpose.bytes += xr.numel() * xr.element_size()
        return torch.view_as_complex(out)


transpose.calls = transpose.bytes = 0


class DistributedSHT(nn.Module):
    """m-parallel spherical harmonic transform over a mesh's 'lat' axis.

    Built from a single-device ``SphericalHarmonicTransform`` (same
    truncation, tensors and conventions), whose blocks it copies; it
    keeps no reference to it.  The transform surface is the single-device
    one's, on rank-local blocks: grid (..., nlat/L, nlon), spectral
    (..., m_block, N+1), rank-2 fields included."""

    _fft = SphericalHarmonicTransform._fft
    _ifft = SphericalHarmonicTransform._ifft
    analyze_many = SphericalHarmonicTransform.analyze_many
    # whole rows: only latitude is cut
    cols = slice(None)
    _contract_analysis = staticmethod(
        SphericalHarmonicTransform._contract_analysis)
    _contract_synthesis = staticmethod(
        SphericalHarmonicTransform._contract_synthesis)

    def __init__(self, sht, mesh, axis='lat'):
        super().__init__()
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.get_group(axis)
        self.L = mesh.shape[mesh.mesh_dim_names.index(axis)]
        self.index = mesh.get_local_rank(axis)
        if dist.get_rank(self.group) != self.index:
            raise RuntimeError(
                'rank %d of the %r group sits at %r index %d: the group '
                'order must be the latitude-block order' % (
                    dist.get_rank(self.group), axis, axis, self.index))
        if sht.nlat % self.L:
            raise ValueError('nlat %d is not divisible by %d %r ranks'
                             % (sht.nlat, self.L, axis))
        M = sht.truncation + 1
        self.m_pad = (-M) % self.L
        self.M_padded = M + self.m_pad
        self.m_block = self.M_padded // self.L
        self.lat_block = sht.nlat // self.L
        self.rows = slice(self.index * self.lat_block,
                          (self.index + 1) * self.lat_block)
        self.m_rows = slice(self.index * self.m_block,
                            (self.index + 1) * self.m_block)

        # mirrored single-device attributes; mu and weights stay global
        self.nlon = sht.nlon
        self.nlat = sht.nlat
        self.truncation = sht.truncation
        self.radius = sht.radius
        self.dtype = sht.dtype
        self.cdtype = sht.cdtype
        self.mu = sht.mu
        self.weights = sht.weights
        self.fft_impl = sht.fft_impl

        def buf(name, t):
            self.register_buffer(name, t.contiguous())

        for name in ('P', 'H', 'Pw', 'Pw_over_cos2', 'Hw_over_cos2'):
            buf(name, self.m_block_of(getattr(sht, name), fill='zero'))
        buf('mask', self.m_block_of(sht.mask, fill='zero'))
        buf('laplacian_eig', self.m_block_of(sht.laplacian_eig))
        buf('inv_laplacian_eig', self.m_block_of(sht.inv_laplacian_eig))
        n = torch.arange(M, dtype=sht.dtype, device=sht.P.device)
        buf('n_2d', self.m_block_of(n[None, :].expand(M, M)))
        m = torch.arange(self.M_padded, dtype=sht.dtype,
                         device=sht.P.device)[self.m_rows]
        buf('im_m', torch.complex(torch.zeros_like(m), m)[:, None])
        buf('coslat', sht.coslat[self.rows])
        if self.fft_impl == 'matmul':       # the zonal DFT is row-local
            for name in DFT_BUFFERS:
                buf(name, getattr(sht, name))

    # -- the layout as DTensor placements (dist_sht.py:163-167) -------------
    def grid_sharding(self):
        """DTensor placements of a rank's grid block (nz, nlat/L, nlon):
        dim 1 sharded over the transform's axis, repeated on every other
        mesh axis, so that ``DTensor.from_local(block, mesh,
        placements)`` is the global field (``parallel.grid_sharding``
        gives the placements of a rank-2 field)."""
        return tuple(Shard(1) if name == self.axis else Replicate()
                     for name in self.mesh.mesh_dim_names)

    # a spectral block (nz, m_block, N+1) is cut on dim 1 as well; its
    # global field has M_padded rows (``pad_spec``)
    spec_sharding = grid_sharding

    # -- where the blocks are cut ------------------------------------------
    def m_block_of(self, a, fill='edge'):
        """This rank's m-block of a per-m tensor (m on dim 0, M rows):
        padded to M_padded with its last row (n-dependent constants, the
        same for every m) or with zeros, then cut."""
        if self.m_pad:
            pad = (a[-1:] if fill == 'edge' else torch.zeros_like(a[-1:]))
            a = torch.cat([a] + [pad] * self.m_pad, dim=0)
        return a[self.m_rows]

    def global_sum(self, x):
        """Sum of a grid-block expression over the whole sphere: the local
        sum, all-reduced over the 'lat' group."""
        return self.global_sums(x)[0]

    def global_sums(self, *xs):
        """``global_sum`` of each argument, through one all_reduce."""
        return tuple(all_reduce_sum([torch.sum(x) for x in xs], self.group))

    def gather_rows(self, x):
        """The global grid field (..., nlat, nlon) of the rank's blocks."""
        return all_gather_cat(x, self.group, self.L, -2)

    def gather_m(self, spec):
        """The global spectral field (..., M, N+1) of the rank's m-blocks,
        the padded rows dropped."""
        return self.unpad_spec(all_gather_cat(spec, self.group, self.L, -2))

    # -- the transposes ------------------------------------------------------
    def _fourier_to_lat(self, fm):
        """(B, nlat/L, M) m-full latitude block -> (B, nlat, m_block)."""
        B = fm.shape[0]
        if self.m_pad:
            fm = nn.functional.pad(fm, (0, self.m_pad))
        x = fm.reshape(B, self.lat_block, self.L, self.m_block)
        y = transpose(x.permute(2, 0, 1, 3), self.group)
        return y.permute(1, 0, 2, 3).reshape(B, self.nlat, self.m_block)

    def _lat_to_fourier(self, fm):
        """(B, nlat, m_block) -> (B, nlat/L, M) m-full latitude block."""
        B = fm.shape[0]
        x = fm.reshape(B, self.L, self.lat_block, self.m_block)
        y = transpose(x.permute(1, 0, 2, 3), self.group)
        y = y.permute(1, 2, 0, 3).reshape(B, self.lat_block, self.M_padded)
        return y[..., :self.truncation + 1]

    def _grid_to_lat(self, grid):
        """Grid blocks (B, nlat/L, nlon) -> Fourier (B, nlat, m_block)."""
        return self._fourier_to_lat(self._fft(grid))

    def _to_grid(self, fm):
        """Fourier (B, nlat, m_block) -> grid blocks (B, nlat/L, nlon)."""
        return self._ifft(self._lat_to_fourier(fm))

    @staticmethod
    def _batch(x):
        """(lead, x as (B, a, b)) for a rank-2-or-more field."""
        return x.shape[:-2], x.reshape((-1,) + tuple(x.shape[-2:]))

    @staticmethod
    def _unbatch(lead, x):
        return x.reshape(tuple(lead) + tuple(x.shape[-2:]))

    # -- full transforms ------------------------------------------------------
    def analyze(self, grid):
        """Grid blocks (..., nlat/L, nlon) -> spectral (..., m_block, N+1)."""
        lead, g = self._batch(grid)
        spec = self._contract_analysis(self.Pw, self._grid_to_lat(g))
        return self._unbatch(lead, spec * self.mask)

    def synthesize(self, spec):
        """Spectral (..., m_block, N+1) -> grid blocks (..., nlat/L, nlon)."""
        lead, s = self._batch(spec)
        return self._unbatch(lead, self._to_grid(
            self._contract_synthesis(self.P, s)))

    def synthesize_dlambda(self, spec):
        """Grid field of the zonal derivative: the i m multiply is m-local."""
        return self.synthesize(spec * self.im_m)

    def synthesize_dmu(self, spec):
        """Grid field of (1 - mu^2) d/dmu."""
        lead, s = self._batch(spec)
        return self._unbatch(lead, self._to_grid(
            self._contract_synthesis(self.H, s)))

    def _pair_to_grid(self, fm_a, fm_b):
        """Two Fourier fields (B, nlat, m_block) through one transpose,
        divided by a cos(latitude): the grid pair (B, nlat/L, nlon)."""
        g = self._to_grid(torch.cat([fm_a, fm_b], dim=0))
        g = g / self.radius / self.coslat
        return g[:fm_a.shape[0]], g[fm_a.shape[0]:]

    def gradient(self, spec):
        """Grid ((1/(a cos)) d/dlambda, (cos/a) d/dmu), one transpose."""
        lead, s = self._batch(spec)
        ddx, ddy = self._pair_to_grid(
            self._contract_synthesis(self.P, s * self.im_m),
            self._contract_synthesis(self.H, s))
        return self._unbatch(lead, ddx), self._unbatch(lead, ddy)

    def uv_from_vort_div(self, vort_spec, div_spec):
        """Grid (u, v) from spectral vorticity and divergence, one
        transpose: psi = inv_lap(zeta), chi = inv_lap(D);
        u cos = (1/a)[d chi/d lambda - (1-mu^2) d psi/d mu],
        v cos = (1/a)[d psi/d lambda + (1-mu^2) d chi/d mu]."""
        lead, vort = self._batch(vort_spec)
        _, div = self._batch(div_spec)
        psi = vort * self.inv_laplacian_eig
        chi = div * self.inv_laplacian_eig
        P, H = self.P, self.H
        fm_u = (self._contract_synthesis(P, chi * self.im_m)
                - self._contract_synthesis(H, psi))
        fm_v = (self._contract_synthesis(P, psi * self.im_m)
                + self._contract_synthesis(H, chi))
        u, v = self._pair_to_grid(fm_u, fm_v)
        return self._unbatch(lead, u), self._unbatch(lead, v)

    def vort_div_analysis(self, A_grid, B_grid):
        """Spectral (curl, div) blocks from grid blocks (U, V) = (u cos,
        v cos), one transpose:
        zeta_nm = (1/a)[i m Q[V] + QH[U]], D_nm = (1/a)[i m Q[U] - QH[V]]."""
        lead, A = self._batch(A_grid)
        _, B = self._batch(B_grid)
        fm = self._grid_to_lat(torch.cat([A, B], dim=0))
        fmA, fmB = fm[:A.shape[0]], fm[A.shape[0]:]
        QA = self._contract_analysis(self.Pw_over_cos2, fmA)
        QB = self._contract_analysis(self.Pw_over_cos2, fmB)
        QHA = self._contract_analysis(self.Hw_over_cos2, fmA)
        QHB = self._contract_analysis(self.Hw_over_cos2, fmB)
        curl = (self.im_m * QB + QHA) / self.radius * self.mask
        div = (self.im_m * QA - QHB) / self.radius * self.mask
        return self._unbatch(lead, curl), self._unbatch(lead, div)

    def laplacian(self, spec):
        return spec * self.laplacian_eig

    def inverse_laplacian(self, spec):
        return spec * self.inv_laplacian_eig

    def filter_spec(self, spec):
        return spec * self.mask

    @property
    def total_wavenumber(self):
        return self.n_2d

    # -- global spectral arrays ---------------------------------------------
    def pad_spec(self, spec):
        """A global (..., M, N+1) spectral array padded to M_padded rows
        (the sharded layout's m extent), numpy or tensor."""
        if not self.m_pad:
            return spec
        if isinstance(spec, torch.Tensor):
            return torch.cat([spec, spec.new_zeros(
                spec.shape[:-2] + (self.m_pad, spec.shape[-1]))], dim=-2)
        width = [(0, 0)] * (np.ndim(spec) - 2) + [(0, self.m_pad), (0, 0)]
        return np.pad(spec, width)

    def unpad_spec(self, spec):
        """The global (..., M, N+1) rows of a padded spectral array."""
        return spec[..., :self.truncation + 1, :]
