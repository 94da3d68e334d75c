"""Replicated-spectral spherical-harmonic transform: the layout that
``shard_model_state`` places a model in (climt_tpu/parallel/mesh.py:57-77).

JAX replicates the spectral state, cuts the grid fields into latitude
blocks (or latitude x longitude blocks with ``shard_lon=True``) and lets
its partitioner derive the collectives of ``climt_tpu/ops/sht.py``.  This
module is what that partitioning amounts to, written out:

  synthesis   no communication: the Legendre sum over every m on the
              rank's latitude rows, the inverse zonal transform to whole
              rows, and with ``shard_lon`` the rank's columns kept;
  analysis    one reduction: with ``shard_lon`` the rank's rows are first
              made whole by an ``all_gather`` over the 'lon' group (the
              zonal transform, ``rfft`` or the matmul DFT as
              ``sht.fft_impl`` says, then is the single-device one); the
              Legendre partial sum over the rank's latitudes;
              ``all_reduce(SUM)`` over the 'lat' group.  ``analyze_many``
              puts every analysis of a dycore stage through one gather
              and one reduction.

Every rank of a 'lat' group receives the same all-reduced bits, and the
'lon' ranks of one row block gather the same whole rows, so the spectral
state, and the spectral part of every step computed from it, stays
bitwise identical on every rank of the mesh.  Complex tensors cross the
collectives as ``torch.view_as_real`` views.

Layouts on the rank at mesh index (i, j) of (L, K):
  grid blocks      (..., nlat/L, nlon/K) with ``shard_lon``, else
                   (..., nlat/L, nlon): rows i*nlat/L .. (i+1)*nlat/L - 1,
                   columns j*nlon/K .. (j+1)*nlon/K - 1;
  spectral fields  (..., M, N+1), whole, as on one device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..ops.sht import DFT_BUFFERS, SphericalHarmonicTransform
from ..utils.profiling import phase


def all_reduce_sum(xs, group):
    """The sums over ``group`` of a list of tensors (real or complex, any
    shapes) through one ``all_reduce``.  Counts its calls in
    ``all_reduce_sum.calls`` and the bytes it hands to the collective in
    ``all_reduce_sum.bytes``."""
    with phase('climt.collective'):
        flat = [torch.view_as_real(x).reshape(-1) if x.is_complex()
                else x.reshape(-1) for x in xs]
        buf = torch.cat(flat)
        dist.all_reduce(buf, group=group)
        all_reduce_sum.calls += 1
        all_reduce_sum.bytes += buf.numel() * buf.element_size()
        out = []
        for x, part in zip(xs, torch.split(buf, [f.numel() for f in flat])):
            if x.is_complex():
                part = torch.view_as_complex(part.reshape(x.shape + (2,)))
            out.append(part.reshape(x.shape))
        return out


all_reduce_sum.calls = all_reduce_sum.bytes = 0


def all_gather_cat(x, group, size, dim):
    """Every rank's x of ``group`` (of ``size`` ranks), concatenated along
    ``dim`` in group-rank order.  Counts its calls in
    ``all_gather_cat.calls`` and the bytes of this rank's x in
    ``all_gather_cat.bytes``."""
    with phase('climt.collective'):
        x = x.contiguous()
        real = torch.view_as_real(x) if x.is_complex() else x
        parts = [torch.empty_like(real) for _ in range(size)]
        dist.all_gather(parts, real, group=group)
        all_gather_cat.calls += 1
        all_gather_cat.bytes += real.numel() * real.element_size()
        if x.is_complex():
            parts = [torch.view_as_complex(p) for p in parts]
        return torch.cat(parts, dim=dim)


all_gather_cat.calls = all_gather_cat.bytes = 0


def _axis(mesh, name):
    """(process group, extent, this rank's index) of a mesh axis, checking
    that the group's rank order is the block order."""
    group = mesh.get_group(name)
    size = mesh.shape[mesh.mesh_dim_names.index(name)]
    index = mesh.get_local_rank(name)
    if dist.get_rank(group) != index:
        raise RuntimeError(
            'rank %d of the %r group sits at %r index %d: the group order '
            'must be the block order' % (dist.get_rank(group), name, name,
                                         index))
    return group, size, index


class ReplicatedSHT(nn.Module):
    """Spherical harmonic transform of a ('lat', 'lon') mesh's blocks with
    the spectral fields whole on every rank.

    Built from a single-device ``SphericalHarmonicTransform`` (same
    truncation, tensors and conventions), whose latitude rows it copies;
    it keeps no reference to it.  The transform surface is the
    single-device one's, on grid blocks and whole spectral fields, rank-2
    fields included; its vector calculus is the single-device code, run on
    the rows and columns the rank holds."""

    # the single-device formulas, on this layout's _fft/_ifft and tensors
    synthesize = SphericalHarmonicTransform.synthesize
    synthesize_dlambda = SphericalHarmonicTransform.synthesize_dlambda
    synthesize_dmu = SphericalHarmonicTransform.synthesize_dmu
    uv_from_vort_div = SphericalHarmonicTransform.uv_from_vort_div
    gradient = SphericalHarmonicTransform.gradient
    laplacian = SphericalHarmonicTransform.laplacian
    m_block_of = staticmethod(SphericalHarmonicTransform.m_block_of)
    _contract_analysis = staticmethod(
        SphericalHarmonicTransform._contract_analysis)
    _contract_synthesis = staticmethod(
        SphericalHarmonicTransform._contract_synthesis)

    def __init__(self, sht, mesh, shard_lon=False):
        super().__init__()
        self.mesh = mesh
        self.shard_lon = bool(shard_lon)
        self.lat_group, self.L, i = _axis(mesh, 'lat')
        self.lon_group, self.K, j = _axis(mesh, 'lon')
        if sht.nlat % self.L:
            raise ValueError('nlat %d is not divisible by %d lat ranks'
                             % (sht.nlat, self.L))
        if self.shard_lon and sht.nlon % self.K:
            raise ValueError('nlon %d is not divisible by %d lon ranks'
                             % (sht.nlon, self.K))
        nrow = sht.nlat // self.L
        self.rows = slice(i * nrow, (i + 1) * nrow)
        ncol = sht.nlon // self.K
        self.cols = (slice(j * ncol, (j + 1) * ncol) if self.shard_lon
                     else slice(None))

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
            buf(name, getattr(sht, name)[..., self.rows])
        for name in ('mask', 'laplacian_eig', 'inv_laplacian_eig', 'im_m'):
            buf(name, getattr(sht, name))
        M = sht.truncation + 1
        n = torch.arange(M, dtype=sht.dtype, device=sht.P.device)
        buf('n_2d', n[None, :].expand(M, M))
        buf('coslat', sht.coslat[self.rows])
        if self.fft_impl == 'matmul':       # the zonal DFT is row-local
            for name in DFT_BUFFERS:
                buf(name, getattr(sht, name))

    # -- zonal stage: whole rows in, the rank's columns out -------------------
    def _fft(self, grid):
        """(..., rows, cols) -> (..., rows, M+1): the single-device zonal
        transform of the whole rows (gathered over 'lon' first under
        ``shard_lon``)."""
        if self.shard_lon:
            grid = all_gather_cat(grid, self.lon_group, self.K, -1)
        return SphericalHarmonicTransform._fft(self, grid)

    def _ifft(self, fm):
        """(..., rows, M+1) -> the rank's columns of the whole rows."""
        return SphericalHarmonicTransform._ifft(self, fm)[..., self.cols]

    # -- analysis: partial Legendre sums, one reduction -----------------------
    def analyze_many(self, grids, pairs=()):
        """([analyze(g) for g in grids], [vort_div_analysis(A, B) for A, B
        in pairs]) through one gather (under ``shard_lon``) and one
        all_reduce over the 'lat' group."""
        fields = list(grids) + [x for pair in pairs for x in pair]
        flat = [f.reshape((-1,) + tuple(f.shape[-2:])) for f in fields]
        fm = self._fft(torch.cat(flat, dim=0))
        fms = [fm_i.reshape(tuple(f.shape[:-2]) + tuple(fm.shape[-2:]))
               for f, fm_i in zip(fields, torch.split(
                   fm, [x.shape[0] for x in flat], dim=0))]
        partial = [self._contract_analysis(self.Pw, f)
                   for f in fms[:len(grids)]]
        for a in range(len(pairs)):
            fmA, fmB = fms[len(grids) + 2 * a:len(grids) + 2 * a + 2]
            partial += [self._contract_analysis(self.Pw_over_cos2, fmA),
                        self._contract_analysis(self.Pw_over_cos2, fmB),
                        self._contract_analysis(self.Hw_over_cos2, fmA),
                        self._contract_analysis(self.Hw_over_cos2, fmB)]
        sums = all_reduce_sum(partial, self.lat_group)
        specs = [s * self.mask for s in sums[:len(grids)]]
        curl_div = []
        for a in range(len(pairs)):
            QA, QB, QHA, QHB = sums[len(grids) + 4 * a:len(grids) + 4 * a + 4]
            curl_div.append(((self.im_m * QB + QHA) / self.radius * self.mask,
                             (self.im_m * QA - QHB) / self.radius * self.mask))
        return specs, curl_div

    def analyze(self, grid):
        """Grid blocks (..., rows, cols) -> spectral (..., M+1, N+1)."""
        return self.analyze_many([grid])[0][0]

    def vort_div_analysis(self, A_grid, B_grid):
        """Spectral (curl, div) from grid blocks (U, V) = (u cos, v cos)."""
        return self.analyze_many([], [(A_grid, B_grid)])[1][0]

    def inverse_laplacian(self, spec):
        return spec * self.inv_laplacian_eig

    def filter_spec(self, spec):
        return spec * self.mask

    @property
    def total_wavenumber(self):
        return self.n_2d

    # -- sums and gathers over the grid blocks --------------------------------
    def global_sums(self, *xs):
        """Sums of grid-block expressions over the whole sphere, one
        all_reduce per sharded axis: over 'lat', and over 'lon' only under
        ``shard_lon`` (a repeated 'lon' block is counted once)."""
        sums = [torch.sum(x) for x in xs]
        if self.shard_lon:
            sums = all_reduce_sum(sums, self.lon_group)
        return tuple(all_reduce_sum(sums, self.lat_group))

    def global_sum(self, x):
        return self.global_sums(x)[0]

    def gather_rows(self, x):
        """The global grid field (..., nlat, nlon) of the ranks' blocks."""
        x = all_gather_cat(x, self.lat_group, self.L, -2)
        if self.shard_lon:
            x = all_gather_cat(x, self.lon_group, self.K, -1)
        return x
