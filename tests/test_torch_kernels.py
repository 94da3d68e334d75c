"""climt_tpu_torch's two radiation kernels: their plain PyTorch versions
against the JAX package, and the CUDA wrappers' refusals.

Kernel B (fused_mix) is held against ``interp.mix_rows``, the function it
replaces on the main path, and against the Pallas ``fused_mix_rows`` run
in interpret mode.  Kernel A (rtrn_kernel) is held against ``rtrn_lw``'s
XLA path at float64 and the Pallas ``rtrn_lw_fused`` in interpret mode at
float32.  The term writer's plain version is held to the JAX taumol by
tests/test_torch_radiation.py.  The CUDA kernels themselves are compared
with these plain versions on a card by tests/test_torch_gpu.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from climt_tpu.components.rrtmg import lw_spectral as L
from climt_tpu.components.rrtmg.fused_mix import fused_mix_rows
from climt_tpu.components.rrtmg.interp import mix_rows
from climt_tpu.components.rrtmg.pallas_rtrn import rtrn_lw_fused
from climt_tpu_torch.components.rrtmg import fused_mix, rtrn_kernel
from climt_tpu_torch.components.rrtmg import lw_spectral as TL
from climt_tpu_torch.components.rrtmg import term_writer

from torch_helpers import (CONTENTION_CASES, contention_bands,
                           ragged_bands, ragged_group, rel_err,
                           taumol_coefs, taumol_columns, to_torch)

HEATFAC = 9.80665 * 8.64e4 / (1004.64 * 1e2)


def _mix_inputs(low=0, high_pad=0):
    """The inputs of test_pallas_radiation.py:24-28."""
    rng = np.random.RandomState(0)
    R, ng, T, nz, nc = 117, 12, 9, 7, 33
    tbl = rng.rand(R, ng)
    idx = rng.randint(low, R + high_pad, (T, nz, nc))
    w = rng.randn(T, nz, nc)
    return tbl, idx, w


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_mix_plain_matches_jax_mix_rows(dtype):
    tbl, idx, w = _mix_inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(mix_rows(jnp.asarray(tbl, jdt), list(zip(
        jnp.asarray(idx, jnp.int32), jnp.asarray(w, jdt)))))
    out = fused_mix.mix_rows(to_torch(tbl, tdt), torch.as_tensor(idx),
                             to_torch(w, tdt))
    assert out.dtype == tdt and out.shape == ref.shape
    # f64: exact gathers on both sides, only the summation order differs;
    # f32: float32 sums of 9 terms
    assert rel_err(out, ref) < (1e-12 if dtype == 'float64' else 1e-6)


def test_mix_plain_matches_pallas_interpret():
    tbl, idx, w = _mix_inputs()
    f32 = jnp.float32
    ref = np.asarray(fused_mix_rows(
        jnp.asarray(tbl, f32), jnp.asarray(idx, jnp.int32),
        jnp.asarray(w, f32), interpret=True))
    out = fused_mix.mix_rows(to_torch(tbl, torch.float32),
                             torch.as_tensor(idx), to_torch(w, torch.float32))
    assert rel_err(out, ref) < 1e-6


def test_mix_plain_clips_out_of_range_indices():
    """Indices below 0 or above R-1 read the first or last row, as
    interp.mix_rows clips them (:45, :51)."""
    tbl, idx, w = _mix_inputs(low=-5, high_pad=5)
    assert (idx < 0).any() and (idx >= tbl.shape[0]).any()
    expect = (w[..., None] * tbl[np.clip(idx, 0, tbl.shape[0] - 1)]).sum(0)
    ref = np.asarray(mix_rows(jnp.asarray(tbl), list(zip(
        jnp.asarray(idx, jnp.int32), jnp.asarray(w)))))
    out = fused_mix.mix_rows(to_torch(tbl), torch.as_tensor(idx),
                             to_torch(w))
    assert rel_err(out, expect) < 1e-12
    assert rel_err(out, ref) < 1e-12


def _rtrn_inputs(nz=9, ncol=40):
    """The cloudy inputs of test_pallas_radiation.py:36-52 (numpy)."""
    rng = np.random.RandomState(1)
    return dict(
        taug=rng.rand(nz, ncol, L.NGPT) * 2.0,
        fracs=rng.rand(nz, ncol, L.NGPT),
        planklay=rng.rand(nz, ncol, 16) * 0.2,
        planklev=rng.rand(nz + 1, ncol, 16) * 0.2,
        plankbnd=rng.rand(ncol, 16) * 0.2,
        semiss=0.9 + 0.1 * rng.rand(16, ncol),
        pwvcm=rng.rand(ncol) * 4,
        cldfrac=(rng.rand(nz, ncol) > 0.5) * rng.rand(nz, ncol),
        taucld_band=rng.rand(nz, ncol, 16) * 3.0,
        pz=np.linspace(1000., 1., nz + 1)[:, None] * np.ones((1, ncol)))


_ORDER = ('taug', 'fracs', 'planklay', 'planklev', 'plankbnd', 'semiss',
          'pwvcm', 'cldfrac', 'taucld_band', 'pz')


def test_rtrn_plain_matches_jax_xla_f64():
    x = _rtrn_inputs()
    ref = L.rtrn_lw(*[jnp.asarray(x[k]) for k in _ORDER], HEATFAC,
                    use_tables=False)
    out = TL.rtrn_lw(*[to_torch(x[k]) for k in _ORDER], HEATFAC,
                     use_tables=False)
    assert len(out) == len(ref) == 6
    for a, b in zip(out, ref):
        assert a.dtype == torch.float64
        assert rel_err(a, b) < 1e-10


def _secdiff_dwave(pwvcm):
    """secdiff (16, ncol) and dwave_g (140,) as rtrn_lw builds them."""
    t = L.load_support()
    fixed = np.zeros(16, bool)
    fixed[[0, 3]] = True
    fixed[9:] = True
    sec = np.clip(t['secdiff_a0'][:, None] + t['secdiff_a1'][:, None]
                  * np.exp(t['secdiff_a2'][:, None] * pwvcm[None]), 1.5, 1.8)
    secdiff = np.where(fixed[:, None], 1.66, sec)
    dwave_g = t['delwave'][L.NGB] * float(t['wtdiff'][0]) * (np.pi * 2.0e4)
    return secdiff, dwave_g


def test_rtrn_plain_matches_pallas_interpret_f32():
    x = _rtrn_inputs()
    secdiff, dwave_g = _secdiff_dwave(x['pwvcm'])
    names = ('taug', 'fracs', 'planklay', 'planklev', 'plankbnd', 'semiss')
    f32 = jnp.float32
    ref = rtrn_lw_fused(
        *[jnp.asarray(x[k], f32) for k in names], jnp.asarray(secdiff, f32),
        jnp.asarray(x['cldfrac'], f32), jnp.asarray(x['taucld_band'], f32),
        jnp.asarray(dwave_g, f32), interpret=True)
    rec_6 = float(L.load_support()['rec_6'][0])
    out = rtrn_kernel.rtrn_lw_fused(
        *[to_torch(x[k], torch.float32) for k in names],
        to_torch(secdiff, torch.float32),
        to_torch(x['cldfrac'], torch.float32),
        to_torch(x['taucld_band'], torch.float32),
        to_torch(dwave_g, torch.float32), rec_6)
    for a, b in zip(out, ref):
        assert a.dtype == torch.float32
        assert rel_err(a, b) < 2e-6


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel launchers take CUDA tensors only; on the CPU the
    dispatchers take the plain versions instead."""
    tbl = torch.zeros((4, 2), dtype=torch.float32)
    idx = torch.zeros((1, 3), dtype=torch.int32)
    w = torch.zeros((1, 3), dtype=torch.float32)
    with pytest.raises(ValueError):
        fused_mix.mix_rows_cuda(tbl, idx, w)
    x = _rtrn_inputs(nz=3, ncol=4)
    secdiff, dwave_g = _secdiff_dwave(x['pwvcm'])
    args = [to_torch(x[k], torch.float32) for k in (
        'taug', 'fracs', 'planklay', 'planklev', 'plankbnd', 'semiss')]
    args += [to_torch(a, torch.float32) for a in (
        secdiff, x['cldfrac'], x['taucld_band'], dwave_g)]
    with pytest.raises(ValueError):
        rtrn_kernel.rtrn_lw_cuda(*args, 1.0 / 6.0)


def _jax_band_sums(bands, jdt):
    """Each band's sum of interp.mix_rows over its parts, side by side."""
    cells = bands[0][1][0][1].shape[1:]
    outs = []
    for ng, parts in bands:
        ref = np.zeros(cells + (ng,))
        for table, idx, w in parts:
            ref = ref + np.asarray(mix_rows(jnp.asarray(table, jdt), list(
                zip(jnp.asarray(idx, jnp.int32), jnp.asarray(w, jdt)))))
        outs.append(ref)
    return np.concatenate(outs, axis=-1)


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_grouped_plain_matches_jax_mix_rows(dtype):
    """Bands of ng 2, 14, 16, 6, 12 and an empty one, each a sum over
    parts of several row counts; indices run past both ends of their
    part's table and are clipped there, as interp.mix_rows clips them."""
    bands = ragged_bands()
    assert any((idx < 0).any() for _, ps in bands for _, idx, _ in ps)
    assert any((idx >= t.shape[0]).any() for _, ps in bands
               for t, idx, _ in ps if t.shape[0] > 1)
    layout, idx, w = ragged_group(bands, getattr(torch, dtype))
    out = fused_mix.mix_groups(layout, idx, w)
    ref = _jax_band_sums(bands, getattr(jnp, dtype))
    assert out.dtype == getattr(torch, dtype) and out.shape == ref.shape
    # f64: exact gathers, only the order of the sum differs; f32: float32
    # sums of up to 7 terms
    assert rel_err(out, ref) < (1e-12 if dtype == 'float64' else 1e-6)


def test_grouped_band_matches_pallas_interpret():
    """One band of the group (ng=14, three parts) against the Pallas kernel
    on the band's tables concatenated row-wise, the indices clipped per part
    and offset as BandAccum.total (fused_mix.py:182-196) builds them."""
    bands = ragged_bands()
    layout, idx, w = ragged_group(bands, torch.float32)
    out = fused_mix.mix_groups(layout, idx, w)
    b = 1
    ng, parts = bands[b]
    off, tables, idxs, ws = 0, [], [], []
    for table, i, wt in parts:
        idxs.append(np.clip(i, 0, table.shape[0] - 1) + off)
        tables.append(table)
        ws.append(wt)
        off += table.shape[0]
    f32 = jnp.float32
    ref = np.asarray(fused_mix_rows(
        jnp.asarray(np.concatenate(tables), f32),
        jnp.asarray(np.concatenate(idxs), jnp.int32),
        jnp.asarray(np.concatenate(ws), f32), interpret=True))
    goff = sum(n for n, _ in bands[:b])
    assert rel_err(out[..., goff:goff + ng], ref) < 1e-6


def test_group_refuses_a_changed_layout():
    """A cached layout is reused only by calls that write the same bands,
    parts and term counts."""
    cells = (3, 5)

    def write(nterms):
        g = fused_mix.Group('test_changed_layout', cells, torch.float64,
                            'cpu')
        g.band(3)
        g.part(np.arange(12.0).reshape(4, 3))
        for _ in range(nterms):
            i, w = g.slot()
            i.fill_(2)
            w.fill_(1.0)
        return g

    expect = torch.tensor([6.0, 7.0, 8.0], dtype=torch.float64)
    assert torch.equal(write(1).run(), expect.expand(cells + (3,)))
    assert torch.equal(write(1).run(), expect.expand(cells + (3,)))
    with pytest.raises(RuntimeError):
        write(2).run()


@pytest.mark.parametrize('case', CONTENTION_CASES)
def test_plain_backward_matches_jax_autodiff_of_mix_rows(case):
    """Kernel B's plain backward (the CPU's, and the card's reference) on
    each contention pattern of torch_helpers.contention_bands, float64,
    against jax.grad of the same weighted sum of interp.mix_rows over each
    band's parts: XLA's autodiff of the gather, where the JAX package
    takes this gradient.  Each part's block of the packed gradient holds
    its table's gradient; the padding columns get nothing."""
    bands = contention_bands(case)
    layout, idx, w = ragged_group(bands, torch.float64)
    rng = np.random.RandomState(200 + CONTENTION_CASES.index(case))
    gout = rng.randn(*idx.shape[1:], layout.width)
    got = fused_mix.mix_groups_bwd_plain(layout, idx, w,
                                         torch.as_tensor(gout)).numpy()
    tables = [jnp.asarray(t) for _, ps in bands for t, _, _ in ps]

    def loss(tables):
        total, k, goff = 0.0, 0, 0
        for ng, ps in bands:
            for _, i, wt in ps:
                out = mix_rows(tables[k], list(zip(
                    jnp.asarray(i, jnp.int32), jnp.asarray(wt))))
                total = total + jnp.sum(out * gout[..., goff:goff + ng])
                k += 1
            goff += ng
        return total

    ref = jax.grad(loss)(tables)
    t, k = 0, 0
    for b, (ng, ps) in enumerate(bands):
        ngp = layout.bands[b][1]
        for table, i, _ in ps:
            base, rows = layout.terms[t]
            block = got[base:base + rows * ngp].reshape(rows, ngp)
            want = np.asarray(ref[k])
            assert np.abs(want).max() > 0
            assert np.abs(block[:, :ng] - want).max() <= (
                1e-12 * np.abs(want).max())
            assert not block[:, ng:].any()
            t += i.shape[0]
            k += 1


def test_term_kinds_match_the_kernel_source():
    """term_writer.KIND and RECORD are csrc/taumol_terms.cu's."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(term_writer.__file__), '..',
                            '..', 'csrc', 'taumol_terms.cu')).read()
    body = re.search(r'enum Kind : int \{(.*?)\};', src, re.S).group(1)
    found = {re.sub(r'(?<!^)([A-Z])', r'_\1', m.group(1)).lower(): int(
        m.group(2)) for m in re.finditer(r'k(\w+) = (\d+)', body)}
    assert found == term_writer.KIND
    assert int(re.search(r'kRecord = (\d+)', src).group(1)) == \
        term_writer.RECORD


def test_term_writer_refuses_cpu_fields():
    cs, wx, _ = taumol_coefs(taumol_columns(nz=4, ncol=6), torch.float32)
    plan = TL.lw_term_plan(TL.load_kdist(), tuple(sorted(wx)))
    plan.finish(torch.float32, 'cpu')
    groups = (fused_mix.Group('test_refuses', (4, 6), torch.float32, 'cpu'),)
    with pytest.raises(ValueError):
        term_writer.taumol_terms_cuda(plan, groups, cs, cs['chi'])
