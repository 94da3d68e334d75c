"""Spherical harmonic transform of the plain reference: ``torch.fft``
for the zonal stage and real Legendre contractions, one device."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .grid import gauss_legendre_nodes


def _legendre_tensors(truncation, mu):
    """P̄[m, n, lat] and H̄[m, n, lat] = (1-mu²) dP̄/dmu in float64 numpy
    (sht.py:35): diagonal seed, three-term recurrence, derivative
    identity."""
    T = truncation
    nlat = mu.shape[0]
    sin_phi = mu
    cos_phi = np.sqrt(1.0 - mu ** 2)
    N = T + 1
    P = np.zeros((T + 1, N + 1, nlat))

    def eps(n, m):
        return np.sqrt((n ** 2 - m ** 2) / (4.0 * n ** 2 - 1.0))

    P[0, 0] = 1.0
    for m in range(1, T + 1):
        P[m, m] = (np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * cos_phi
                   * P[m - 1, m - 1])
    for m in range(0, T + 1):
        if m + 1 <= N:
            P[m, m + 1] = np.sqrt(2.0 * m + 3.0) * sin_phi * P[m, m]
    for m in range(0, T + 1):
        for n in range(m + 2, N + 1):
            P[m, n] = (sin_phi * P[m, n - 1]
                       - eps(n - 1, m) * P[m, n - 2]) / eps(n, m)

    H = np.zeros((T + 1, T + 1, nlat))
    for m in range(0, T + 1):
        for n in range(m, T + 1):
            term = -n * eps(n + 1, m) * P[m, n + 1]
            if n - 1 >= m:
                term = term + (n + 1.0) * eps(n, m) * P[m, n - 1]
            H[m, n] = term
    return P[:, :T + 1, :], H


def complex_dtype(dtype):
    return torch.complex64 if dtype == torch.float32 else torch.complex128


class SphericalHarmonicTransform(nn.Module):
    """Batched-matmul spherical harmonic transform for one resolution."""

    def __init__(self, nlon, nlat, truncation=None, radius=6.371e6,
                 dtype=torch.float64, device='cuda'):
        super().__init__()
        if truncation is None:
            truncation = min((2 * nlat - 1) // 3, (nlon - 1) // 3)
        self.nlon, self.nlat = nlon, nlat
        self.truncation = truncation
        self.radius = radius
        self.dtype = dtype
        self.cdtype = complex_dtype(dtype)

        mu, w = gauss_legendre_nodes(nlat)
        mu = mu[::-1].copy()                  # latitude 0 = northernmost
        w = w[::-1].copy()
        self.mu = mu                          # host numpy copies
        self.weights = w

        P, H = _legendre_tensors(truncation, mu)

        def buf(name, arr, dt=dtype):
            self.register_buffer(
                name, torch.as_tensor(np.ascontiguousarray(arr), dtype=dt,
                                      device=device))

        buf('P', P)                                        # (M, N, lat)
        buf('H', H)
        buf('Pw', P * (w / 2.0))
        buf('Pw_over_cos2', P * (w / (2.0 * (1.0 - mu ** 2))))
        buf('Hw_over_cos2', H * (w / (2.0 * (1.0 - mu ** 2))))
        n = np.arange(truncation + 1)
        m = np.arange(truncation + 1)
        buf('mask', (n[None, :] >= m[:, None]).astype(np.float64))
        buf('laplacian_eig', np.broadcast_to(
            (-n * (n + 1.0) / radius ** 2)[None, :],
            (truncation + 1, truncation + 1)))
        inv = np.zeros(truncation + 1)
        inv[1:] = -radius ** 2 / (n[1:] * (n[1:] + 1.0))
        buf('inv_laplacian_eig', np.broadcast_to(
            inv[None, :], (truncation + 1, truncation + 1)))
        buf('coslat', np.sqrt(1.0 - mu ** 2)[:, None])     # (lat, 1)
        buf('im_m', (1j * m.astype(np.float64))[:, None],   # (M, 1)
            self.cdtype)

    # -- zonal (Fourier) stage ------------------------------------------
    def _fft(self, grid):
        """(..., nlat, nlon) -> (..., nlat, M+1) complex Fourier coeffs."""
        fm = torch.fft.rfft(grid, dim=-1) / self.nlon
        return fm[..., :self.truncation + 1]

    def _ifft(self, fm):
        """(..., nlat, M+1) -> (..., nlat, nlon) real grid."""
        nfreq = self.nlon // 2 + 1
        fm_full = nn.functional.pad(fm, (0, nfreq - fm.shape[-1]))
        return torch.fft.irfft(fm_full * self.nlon, n=self.nlon, dim=-1)

    # -- Legendre contractions ------------------------------------------
    @staticmethod
    def _contract_analysis(tensor, fm):
        """einsum('mnl,...lm->...mn') with a real tensor, complex fm."""
        re = torch.einsum('mnl,...lm->...mn', tensor, fm.real)
        im = torch.einsum('mnl,...lm->...mn', tensor, fm.imag)
        return torch.complex(re, im)

    @staticmethod
    def _contract_synthesis(tensor, spec):
        """einsum('mnl,...mn->...lm') with a real tensor, complex spec."""
        re = torch.einsum('mnl,...mn->...lm', tensor, spec.real)
        im = torch.einsum('mnl,...mn->...lm', tensor, spec.imag)
        return torch.complex(re, im)

    # -- full transforms --------------------------------------------------
    def analyze(self, grid):
        """Grid (..., nlat, nlon) -> spectral (..., M+1, N+1) complex."""
        return self._contract_analysis(self.Pw, self._fft(grid)) * self.mask

    def synthesize(self, spec):
        """Spectral (..., M+1, N+1) -> grid (..., nlat, nlon)."""
        return self._ifft(self._contract_synthesis(self.P, spec))

    def synthesize_dlambda(self, spec):
        """Grid field of the zonal derivative ∂g/∂lambda."""
        return self.synthesize(spec * self.im_m)

    def synthesize_dmu(self, spec):
        """Grid field of (1 - mu²) ∂g/∂mu."""
        return self._ifft(self._contract_synthesis(self.H, spec))

    # -- vector calculus -----------------------------------------------
    def uv_from_vort_div(self, vort_spec, div_spec):
        """Grid (u, v) from spectral vorticity and divergence (sht.py:229)."""
        psi = vort_spec * self.inv_laplacian_eig
        chi = div_spec * self.inv_laplacian_eig
        u_cos = (self.synthesize_dlambda(chi)
                 - self.synthesize_dmu(psi)) / self.radius
        v_cos = (self.synthesize_dlambda(psi)
                 + self.synthesize_dmu(chi)) / self.radius
        return u_cos / self.coslat, v_cos / self.coslat

    def vort_div_analysis(self, A_grid, B_grid):
        """Spectral (curl, div) pair from grid (U, V) = (u cos, v cos)
        (sht.py:246)."""
        fmA = self._fft(A_grid)
        fmB = self._fft(B_grid)
        QA = self._contract_analysis(self.Pw_over_cos2, fmA)
        QB = self._contract_analysis(self.Pw_over_cos2, fmB)
        QHA = self._contract_analysis(self.Hw_over_cos2, fmA)
        QHB = self._contract_analysis(self.Hw_over_cos2, fmB)
        curl = (self.im_m * QB + QHA) / self.radius * self.mask
        div = (self.im_m * QA - QHB) / self.radius * self.mask
        return curl, div

    def gradient(self, spec):
        """Grid ((1/(a cos)) d/dlambda, (cos/a) d/dmu) of a spectral field."""
        ddx = self.synthesize_dlambda(spec) / self.radius / self.coslat
        ddy = self.synthesize_dmu(spec) / self.radius / self.coslat
        return ddx, ddy

    def laplacian(self, spec):
        return spec * self.laplacian_eig

    def inverse_laplacian(self, spec):
        return spec * self.inv_laplacian_eig

    def filter_spec(self, spec):
        """Apply the triangular truncation mask."""
        return spec * self.mask

    def analyze_many(self, grids, pairs=()):
        """([analyze(g) for g in grids], [vort_div_analysis(A, B) for A, B
        in pairs]): a dycore stage's analyses together, which a mesh layout
        reduces in one collective."""
        return ([self.analyze(g) for g in grids],
                [self.vort_div_analysis(a, b) for a, b in pairs])

    @staticmethod
    def global_sum(x):
        """Sum of a grid expression over the sphere."""
        return torch.sum(x)

    @staticmethod
    def global_sums(*xs):
        """``global_sum`` of each argument."""
        return tuple(torch.sum(x) for x in xs)
