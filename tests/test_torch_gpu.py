"""climt_tpu_torch's CUDA kernels against their plain PyTorch versions.

Every test here needs a CUDA GPU and skips itself elsewhere.  The file
imports neither jax nor climt_tpu, so on a machine with a card and
without jax it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import copy
import datetime
from datetime import timedelta

import numpy as np
import pytest
import torch

import climt_tpu_torch as ct

from climt_tpu_torch.components import emanuel_convection as E
from climt_tpu_torch.components.rrtmg import fused_mix, rtrn_kernel
from climt_tpu_torch.components.rrtmg import lw_spectral as TL
from climt_tpu_torch.components.rrtmg import term_writer as TW
from climt_tpu_torch.convert import carry_to_numpy
from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm

from torch_helpers import (CONTENTION_CASES, LW_TABLE_CASES,
                           contention_bands, term_writer_check,
                           port_example, port_lw, port_sw,
                           port_taumol_groups, radiation_columns,
                           ragged_bands, ragged_group, rel_err,
                           smoke_constant, to_torch, ice_fields)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (torch.cuda.is_available() is false)')
    return torch.device('cuda:0')


@pytest.mark.gpu
def test_mix_rows_cuda_matches_plain(cuda):
    rng = np.random.RandomState(2)
    R, ng, T, S = 1175, 16, 8, (28, 512)
    tbl = to_torch(rng.rand(R, ng), torch.float32, cuda)
    idx = torch.as_tensor(rng.randint(-3, R + 3, (T,) + S),
                          dtype=torch.int32, device=cuda)
    w = to_torch(rng.randn(T, *S), torch.float32, cuda)
    before = fused_mix.mix_groups_cuda.launches
    out = fused_mix.mix_rows(tbl, idx, w)
    assert fused_mix.mix_groups_cuda.launches == before + 1
    assert rel_err(out, fused_mix.mix_rows_plain(tbl, idx.long(), w)) < 1e-6


def _rtrn_args(nz, ncol, device):
    rng = np.random.RandomState(1)

    def r(*shape):
        return to_torch(rng.rand(*shape), torch.float32, device)

    return (r(nz, ncol, 140) * 2.0, r(nz, ncol, 140), r(nz, ncol, 16) * 0.2,
            r(nz + 1, ncol, 16) * 0.2, r(ncol, 16) * 0.2,
            0.9 + 0.1 * r(16, ncol), 1.5 + 0.3 * r(16, ncol),
            (r(nz, ncol) > 0.5) * r(nz, ncol), r(nz, ncol, 16) * 3.0,
            r(140) * 100.0)


@pytest.mark.gpu
@pytest.mark.parametrize('nz', [9, 28, 60])
def test_rtrn_lw_cuda_matches_plain(cuda, nz):
    """At nz=60 one column's tile needs more than 48 KB of shared memory."""
    args = _rtrn_args(nz, 256, cuda)
    rec_6 = TL._support_scalar('rec_6')
    before = rtrn_kernel.rtrn_lw_cuda.launches
    out = rtrn_kernel.rtrn_lw_fused(*args, rec_6)
    assert rtrn_kernel.rtrn_lw_cuda.launches == before + 1
    for a, b in zip(out, rtrn_kernel.rtrn_lw_plain(*args, rec_6)):
        assert rel_err(a, b) < 2e-6


@pytest.mark.gpu
def test_cuda_wrappers_refuse_float64(cuda):
    """Kernel A has no float64 instantiation and refuses it."""
    args = [a.double() for a in _rtrn_args(9, 8, cuda)]
    with pytest.raises(TypeError):
        rtrn_kernel.rtrn_lw_cuda(*args, TL._support_scalar('rec_6'))


@pytest.mark.gpu
def test_grouped_kernel_matches_plain_in_float64(cuda):
    """Kernel B's float64 instantiation on the ragged bands, 9300 cells,
    to 1e-12 of max."""
    layout, idx, w = ragged_group(ragged_bands(cells=(31, 300)),
                                  torch.float64, cuda)
    before = fused_mix.mix_groups_cuda.launches
    out = fused_mix.mix_groups_cuda(layout, idx, w)
    assert out.dtype == torch.float64
    assert fused_mix.mix_groups_cuda.launches == before + 1
    assert rel_err(out, fused_mix.mix_groups_plain(layout, idx, w)) < 1e-12


@pytest.mark.gpu
def test_moist_gcm_gpu_matches_cpu(cuda):
    """2 float32 steps at 32x16x10 (a radiation refresh at step 0) on the
    card against the CPU; both kernels must launch."""
    kw = dict(nlon=32, nlat=16, nz=10, rad_every=6, rad_col_chunk=128,
              dtype=torch.float32)
    out = {}
    for dev in ('cpu', cuda):
        _, init_fn, _, run_fn = build_moist_gcm(device=dev, **kw)
        a0 = rtrn_kernel.rtrn_lw_cuda.launches
        b0 = fused_mix.mix_groups_cuda.launches
        carry, _ = run_fn(init_fn(0), 2)
        out[str(dev)] = carry_to_numpy(carry)[2]
    assert rtrn_kernel.rtrn_lw_cuda.launches > a0
    assert fused_mix.mix_groups_cuda.launches > b0
    for key, tol in (('T', 0.01), ('u', 0.02), ('v', 0.02), ('ps', 15.0)):
        assert np.abs(out['cuda:0'][key] - out['cpu'][key]).max() < tol


@pytest.mark.gpu
def test_grouped_kernel_matches_plain_on_ragged_bands(cuda):
    """Bands of ng 2, 14, 16, 6, 12 and an empty one, with clipping at both
    ends of every part; 9300 cells, so the last tile of 128 is partial."""
    layout, idx, w = ragged_group(ragged_bands(cells=(31, 300)),
                                  torch.float32, cuda)
    before = fused_mix.mix_groups_cuda.launches
    out = fused_mix.mix_groups_cuda(layout, idx, w)
    assert fused_mix.mix_groups_cuda.launches == before + 1
    assert rel_err(out, fused_mix.mix_groups_plain(layout, idx, w)) < 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize('name', ['lw_taug', 'lw_fracs', 'sw_taug',
                                  'sw_taur', 'sw_sflux'])
def test_taumol_group_kernel_matches_plain(cuda, name):
    """The real groups of 512 physical columns, nz=28."""
    group = port_taumol_groups(radiation_columns(nz=28, ncol=512),
                               torch.float32, cuda)[name]
    layout, idx, w = group.finish()
    out = fused_mix.mix_groups_cuda(layout, idx, w)
    assert rel_err(out, fused_mix.mix_groups_plain(layout, idx, w)) < 1e-6


@pytest.mark.gpu
def test_t85_chunk_radiation_makes_few_kernel_b_launches(cuda):
    """One radiation call on a T85 chunk (nz=28, 8192 columns): LW + SW
    make at most 10 launches of kernel B (6 by design)."""
    c = radiation_columns(nz=28, ncol=8192)
    before = fused_mix.mix_groups_cuda.launches
    port_lw(c, torch.float32, cuda)
    port_sw(c, torch.float32, cuda)
    assert 0 < fused_mix.mix_groups_cuda.launches - before <= 10


@pytest.mark.gpu
def test_rrtmg_components_on_the_card_match_the_cpu(cuda):
    """RRTMGLongwave and RRTMGShortwave at float64 on a cloudy 8x4x20
    default state: kernel B runs in float64 (3 groups each), kernel A not
    at all, and every output agrees with the CPU to 1e-9 of max."""
    outs = {}
    launches = {}
    for dev in ('cpu', cuda):
        comps = [ct.RRTMGLongwave(device=dev), ct.RRTMGShortwave(device=dev)]
        state = ct.get_default_state(
            comps, grid_state=ct.get_grid(nx=8, ny=4, nz=20))
        state['cloud_area_fraction_in_atmosphere_layer'].values[5:9] = 0.6
        state['mass_content_of_cloud_liquid_water_in_atmosphere_layer'
              ].values[5:9] = 40.0
        state['zenith_angle'].values[:] = 0.5
        a0 = rtrn_kernel.rtrn_lw_cuda.launches
        b0 = fused_mix.mix_groups_cuda.launches
        outs[str(dev)] = [comp(state) for comp in comps]
        launches[str(dev)] = (rtrn_kernel.rtrn_lw_cuda.launches - a0,
                              fused_mix.mix_groups_cuda.launches - b0)
    assert launches['cpu'] == (0, 0)
    assert launches['cuda:0'] == (0, 6)
    for card, host in zip(outs['cuda:0'], outs['cpu']):
        for part_c, part_h in zip(card, host):
            for name, value in part_h.items():
                assert part_c[name].values.is_cuda, name
                assert part_c[name].values.dtype == torch.float64, name
                assert rel_err(part_c[name].values, value.values) < 1e-9, \
                    name


@pytest.mark.gpu
def test_component_api_runs_on_the_card(cuda):
    """examples/held_suarez.py's component path, 3 calls at 32x16x10: the
    state's numpy arrays come back as CUDA tensors."""
    dycore = ct.GFSDynamicalCore([ct.HeldSuarez(device=cuda)],
                                 number_of_damped_levels=5, moist=False,
                                 device=cuda)
    state = ct.get_default_state(
        [dycore], grid_state=ct.get_grid(nx=32, ny=16, nz=10))
    for _ in range(3):
        _, new_state = dycore(state, timedelta(minutes=15))
        state.update(new_state)
    assert new_state
    for name, value in new_state.items():
        assert value.values.is_cuda, name
        assert bool(torch.isfinite(value.values).all()), name


# the components of the land-surface, column and insolation slice, with
# the options that take other code paths
SLICE_COMPONENTS = [
    ('Instellation', {}), ('GridScaleCondensation', {}),
    ('DryConvectiveAdjustment', {}), ('DcmipInitialConditions', {}),
    ('DcmipInitialConditions', dict(moist=True,
                                    condition_type='tropical_cyclone')),
    ('SimpleBoundaryLayer', {}),
    ('SimpleBoundaryLayer', dict(surface_fluxes='external')),
    ('BucketHydrology', {}), ('BucketHydrology', dict(num_layers=2)),
    ('SeaIce', {}), ('LandIce', {}), ('BergerSolarInsolation', {}),
    ('LandMask', {}), ('DataOcean', {}), ('SecondBEST', {})]


@pytest.mark.gpu
@pytest.mark.parametrize('name, options', SLICE_COMPONENTS,
                         ids=lambda x: x if isinstance(x, str) else
                         ','.join(x) or 'default')
def test_slice_component_on_the_card_matches_the_cpu(cuda, name, options):
    """One call at 16x8x10 float64 on the card and on the CPU, on the
    same inputs: every floating output a CUDA tensor within 1e-9 of the
    CPU's max.  Dry convection gets a column whose potential temperature
    falls 3% a level, so every level mixes and no instability test sits
    near its threshold."""
    outs = {}
    for dev in ('cpu', cuda):
        comp = getattr(ct, name)(device=dev, **options)
        state = ct.get_default_state(
            [comp], grid_state=ct.get_grid(nx=16, ny=8, nz=10))
        fields = ice_fields(state, np.random.RandomState(0))
        p = np.asarray(state['air_pressure'].values)
        if name == 'DryConvectiveAdjustment':
            fields['specific_humidity'] = np.zeros_like(p)
            fields['air_temperature'] = 300.0 * (p / 1e5) ** (
                287.04 / 1004.64) * 0.97 ** np.arange(p.shape[0])[
                    :, None, None]
        for key, value in fields.items():
            if key in state:
                state[key].values[:] = value
        state['time'] = datetime.datetime(2000, 6, 1, 9)
        out = (comp(state) if isinstance(comp, ct.DiagnosticComponent)
               else comp(state, timedelta(minutes=30)))
        outs[str(dev)] = out if isinstance(out, tuple) else (out,)
    for card, host in zip(outs['cuda:0'], outs['cpu']):
        assert set(card) == set(host)
        for key, value in host.items():
            if not (isinstance(value.values, torch.Tensor)
                    and value.values.is_floating_point()):
                continue
            assert card[key].values.is_cuda, key
            assert rel_err(card[key].values, value.values) < 1e-9, key


@pytest.mark.gpu
def test_insolation_example_makes_six_kernel_b_launches_per_refresh(cuda):
    """examples/full_radiation_with_insolation_gcm.py at 16x8x8 for 7
    calls on the card: RRTMG refreshes at calls 0 and 6, each with 6
    float64 kernel-B launches and no kernel-A launch."""
    main, calls = port_example('full_radiation_with_insolation_gcm')
    a0 = rtrn_kernel.rtrn_lw_cuda.launches
    b0 = fused_mix.mix_groups_cuda.launches
    state = main(verbose=False, n_steps=7, nx=16, ny=8, nz=8)
    assert len(calls.seconds) == 7
    assert fused_mix.mix_groups_cuda.launches - b0 == 2 * 6
    assert rtrn_kernel.rtrn_lw_cuda.launches == a0
    assert state['zenith_angle'].values.is_cuda



def _transport_case(device, dtype=torch.float64, nlat=32, nlon=64, nz=10):
    """A blob, noisy divergent winds and a vertical mass flux on the
    64x32 Gaussian grid (five FV zonal bands at dt_max 1200 s)."""
    from climt_tpu_torch.ops.sht import SphericalHarmonicTransform
    sht = SphericalHarmonicTransform(nlon, nlat, dtype=torch.float64,
                                     device='cpu')
    rng = np.random.RandomState(0)
    lon = 2 * np.pi * np.arange(nlon) / nlon
    L, F = np.meshgrid(lon, np.arcsin(sht.mu))
    q = 1e-3 * (1.0 + np.exp(-((F - 0.3) ** 2 / 0.08
                               + (L - np.pi) ** 2 / 0.3)))
    fields = (np.broadcast_to(q, (nz, nlat, nlon)),
              2000.0 + 3000.0 * rng.rand(nz, nlat, nlon),
              20.0 * np.cos(F) + 30.0 * rng.randn(nz, nlat, nlon),
              5.0 * rng.randn(nz, nlat, nlon),
              0.01 * rng.randn(nz - 1, nlat, nlon))
    return (sht.mu, sht.weights, nlon), [to_torch(x, dtype, device)
                                         for x in fields]


@pytest.mark.gpu
@pytest.mark.parametrize('kind', ['fv', 'sl'])
def test_transport_operator_on_the_card_matches_the_cpu(cuda, kind):
    """FVAdvection and SLAdvection at 64x32x10 float64, two tracers in one
    batch: the card within 1e-12 of the CPU's max (the same operations;
    SL's bilinear weights are continuous in a corner index)."""
    from climt_tpu_torch.ops.fv_advection import FVAdvection
    from climt_tpu_torch.ops.sl_advection import SLAdvection
    cls = FVAdvection if kind == 'fv' else SLAdvection
    out = {}
    for dev in ('cpu', cuda):
        grid, (q, dp, u, v, mdot) = _transport_case(dev)
        op = cls(*grid, 6.371e6, 1200.0, dtype=torch.float64, device=dev)
        batch = torch.stack([q, 1.0 - q])
        out[str(dev)] = op.advect(batch, dp, u, v, mdot, 1200.0)
    assert out['cuda:0'].is_cuda
    assert rel_err(out['cuda:0'], out['cpu']) < 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize('mode', ['fv', 'sl'])
def test_moist_gcm_grid_moisture_on_the_card_matches_the_cpu(cuda, mode):
    """2 float32 steps at 32x16x10 with grid moisture on the card against
    the CPU, as test_moist_gcm_gpu_matches_cpu; q stays a real grid."""
    kw = dict(nlon=32, nlat=16, nz=10, rad_every=6, rad_col_chunk=128,
              dtype=torch.float32, moisture_advection=mode)
    out = {}
    for dev in ('cpu', cuda):
        _, init_fn, _, run_fn = build_moist_gcm(device=dev, **kw)
        carry, _ = run_fn(init_fn(0), 2)
        assert not carry[1]['q'].is_complex()
        out[str(dev)] = carry_to_numpy(carry)[2]
    for key, tol in (('T', 0.01), ('u', 0.02), ('v', 0.02), ('q', 5e-6),
                     ('ps', 15.0)):
        assert np.abs(out['cuda:0'][key] - out['cpu'][key]).max() < tol


@pytest.mark.gpu
def test_registered_tracers_on_the_card_match_the_cpu(cuda):
    """GFSDynamicalCore with FV moisture and two registered tracers, 3
    calls at 32x16x10 float64: the tracers come back as CUDA tensors
    within 1e-9 of the CPU's max, the uniform one to 1e-10 of itself."""
    ct.reset_tracers()
    ct.register_tracer('tracer_blob', 'kg/kg')
    ct.register_tracer('tracer_uniform', 'kg/kg')
    try:
        outs = {}
        for dev in ('cpu', cuda):
            dycore = ct.GFSDynamicalCore(device=dev, moisture_advection='fv')
            state = ct.get_default_state(
                [dycore], grid_state=ct.get_grid(nx=32, ny=16, nz=10))
            shape = state['air_temperature'].shape
            state['eastward_wind'].values[:] = 12.0
            blob = np.exp(-((np.arange(shape[-1]) - 8) / 2.0) ** 2)
            for name, field in (('tracer_blob', blob + np.zeros(shape)),
                                ('tracer_uniform', np.full(shape, 0.5))):
                state[name] = ct.DataArray(
                    field, dims=['mid_levels', 'lat', 'lon'],
                    attrs={'units': 'kg/kg'})
            for _ in range(3):
                _, new_state = dycore(state, timedelta(minutes=10))
                state.update(new_state)
            outs[str(dev)] = state
        for name in ('tracer_blob', 'tracer_uniform', 'specific_humidity'):
            card = outs['cuda:0'][name].values
            assert card.is_cuda, name
            assert rel_err(card, outs['cpu'][name].values) < 1e-9, name
        uniform = outs['cuda:0']['tracer_uniform'].values
        assert float((uniform - 0.5).abs().max()) < 0.5e-10
    finally:
        ct.reset_tracers()
        ct.reset_packers()


@pytest.mark.gpu
def test_native_monitor_stores_a_cuda_state(cuda, tmp_path):
    """NetCDFMonitor (native writer) and RestartMonitor on a state held
    on the card: the files hold the card's values exactly."""
    from scipy.io import netcdf_file
    rng = np.random.RandomState(0)
    T = rng.rand(3, 8, 16, 10)
    nc = ct.NetCDFMonitor(str(tmp_path / 'out.nc'), write_on_store=True,
                          backend='native')
    restart = ct.RestartMonitor(str(tmp_path / 'restart'))
    t0 = datetime.datetime(2000, 1, 1)
    for k in range(3):
        state = {'time': t0 + timedelta(hours=k),
                 'air_temperature': ct.DataArray(
                     to_torch(T[k], torch.float64, cuda),
                     ('lon', 'lat', 'mid_levels'), {'units': 'degK'})}
        nc.store(state)
    restart.store(state)
    nc.close()
    f = netcdf_file(str(tmp_path / 'out.nc'), 'r', mmap=False)
    np.testing.assert_array_equal(f.variables['air_temperature'].data, T)
    f.close()
    loaded = restart.load()
    np.testing.assert_array_equal(loaded['air_temperature'].values, T[2])
    assert loaded['time'] == state['time']


@pytest.mark.gpu
def test_moist_gcm_on_a_world_of_one_nccl_rank(cuda, tmp_path):
    """build_moist_gcm(mesh=make_mesh(1)) on one NCCL rank, 7 float32
    steps at 32x16x10, gathered, against the single-device model on the
    card within chip_smoke.py's SMALL_TOL."""
    import torch.distributed as dist
    from climt_tpu_torch.convert import carry_to_global
    from climt_tpu_torch.parallel import initialize_distributed, make_mesh
    kw = dict(nlon=32, nlat=16, nz=10, rad_every=6, rad_col_chunk=128,
              dtype=torch.float32, device=cuda)
    _, init_fn, _, run_fn = build_moist_gcm(**kw)
    ref = carry_to_numpy(run_fn(init_fn(0), 7)[0])[2]
    assert initialize_distributed('file://%s' % (tmp_path / 'store'), 1,
                                  0) == 1
    try:
        assert dist.get_backend() == 'nccl'
        dycore, init_fn, _, run_fn = build_moist_gcm(mesh=make_mesh(1), **kw)
        got = carry_to_global(run_fn(init_fn(0), 7)[0], dycore.sht)[2]
    finally:
        dist.destroy_process_group()
    for key, tol in (('T', 0.01), ('u', 0.02), ('v', 0.02), ('q', 5e-6),
                     ('ps', 15.0)):
        assert np.abs(got[key] - ref[key]).max() < tol, key


@pytest.mark.gpu
@pytest.mark.parametrize('shard_lon', [False, True])
def test_replicated_layout_on_a_world_of_one_nccl_rank(cuda, tmp_path,
                                                       shard_lon):
    """A model built without a mesh, its carry placed by
    shard_model_state on make_mesh(1) over one NCCL rank and stepped by
    its own run_fn: 7 float32 steps at 32x16x10, gathered, against the
    single-device model on the card within chip_smoke.py's SMALL_TOL."""
    import torch.distributed as dist
    from climt_tpu_torch.convert import carry_to_global
    from climt_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                          shard_model_state)
    kw = dict(nlon=32, nlat=16, nz=10, rad_every=6, rad_col_chunk=128,
              dtype=torch.float32, device=cuda)
    _, init_fn, _, run_fn = build_moist_gcm(**kw)
    ref = carry_to_numpy(run_fn(init_fn(0), 7)[0])[2]
    assert initialize_distributed('file://%s' % (tmp_path / 'store'), 1,
                                  0) == 1
    try:
        assert dist.get_backend() == 'nccl'
        carry = shard_model_state(make_mesh(1), *init_fn(0),
                                  shard_lon=shard_lon)
        got = carry_to_global(run_fn(carry, 7)[0])[2]
    finally:
        dist.destroy_process_group()
    for key, tol in (('T', 0.01), ('u', 0.02), ('v', 0.02), ('q', 5e-6),
                     ('ps', 15.0)):
        assert np.abs(got[key] - ref[key]).max() < tol, key


@pytest.mark.gpu
def test_numpy_reads_a_card_field_and_writes_stay_on_the_card(cuda):
    """np.asarray(state[name].values) of a CUDA field copies it to the
    host; values[:] = ... writes on the card; torch operations on the
    field return plain CUDA tensors."""
    from climt_tpu_torch.core.dataarray import HostTensor
    dycore = ct.GFSDynamicalCore([ct.HeldSuarez(device=cuda)],
                                 number_of_damped_levels=5, moist=False,
                                 device=cuda)
    state = ct.get_default_state(
        [dycore], grid_state=ct.get_grid(nx=32, ny=16, nz=10))
    _, new_state = dycore(state, timedelta(minutes=15))
    state.update(new_state)
    field = state['air_temperature']
    assert type(field.values) is HostTensor and field.values.is_cuda
    host = np.asarray(field.values)
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, field.values.cpu().numpy())
    out = field.values * 2.0
    assert type(out) is torch.Tensor and out.is_cuda
    field.values[:] = 250.0
    assert field.values.is_cuda
    assert float(field.values.min()) == float(field.values.max()) == 250.0
    assert np.asarray(state['air_temperature'].values).max() == 250.0


CORK_CASES = ('earth_low_res_lw', 'earth_low_res_lw_4band_ngpt2_before',
              'mars_lw', 'single_band_gray_lw', 'single_band_unit_lw',
              'test_2band_lw', 'titan_lw', 'tour_gray_lw',
              'trappist1e_hab1_lw', 'trappist1e_hab2_lw', 'venus_lw', 'esft',
              'parmentier')


@pytest.fixture
def band_count():
    """CORK declares its band count in a module global: restore it."""
    from climt_tpu_torch.core import initialization
    saved = initialization._num_longwave_bands
    yield
    initialization._num_longwave_bands = saved


@pytest.mark.gpu
@pytest.mark.parametrize('name', CORK_CASES)
def test_cork_on_the_card_matches_the_cpu(cuda, band_count, name):
    """CorkLongwaveRadiation.array_call on 28 levels x 16 columns with
    clouds and diagnostics_level 1, every output on the card within 1e-12
    of the CPU's max (the same operations; exp, log and pow round
    differently on the card)."""
    from climt_tpu_torch.components.cork.lw import CorkLongwaveRadiation
    from torch_helpers import cork_columns, esft_table
    kw = (dict(optics='parmentier') if name == 'parmentier' else
          dict(table=esft_table() if name == 'esft' else name))
    out = {}
    for dev in ('cpu', cuda):
        comp = CorkLongwaveRadiation(device=dev, diagnostics_level=1, **kw)
        tend, diag = comp.array_call(cork_columns(comp.num_longwave_bands,
                                                  hot=name == 'parmentier'))
        out[str(dev)] = dict(diag, tendency=tend['T'])
    for key, ref in out['cpu'].items():
        got = out['cuda:0'][key]
        assert got.is_cuda, key
        assert rel_err(got, ref) < 1e-12, key


@pytest.mark.gpu
def test_cork_builds_on_the_card_by_default(cuda, band_count):
    from climt_tpu_torch.components.cork.lw import CorkLongwaveRadiation
    comp = CorkLongwaveRadiation(table='mars_lw')
    assert comp.device.type == 'cuda'
    state = ct.get_default_state([comp], grid_state=ct.get_grid(
        nx=16, ny=8, nz=8))
    tendencies, diagnostics = comp(state)
    assert tendencies['air_temperature'].values.is_cuda
    assert diagnostics['upwelling_longwave_flux_in_air'].values.is_cuda


@pytest.mark.gpu
def test_matmul_dft_on_the_card_matches_the_cpu(cuda):
    """The matmul zonal DFT's analysis and synthesis at 64x32 float64
    within 1e-12 of the CPU, and 2 float32 steps of the moist GCM with it
    at 32x16x10, as test_moist_gcm_gpu_matches_cpu."""
    from climt_tpu_torch.ops.sht import SphericalHarmonicTransform
    grid = np.random.RandomState(8).randn(4, 32, 64)
    spec = {}
    for dev in ('cpu', cuda):
        sht = SphericalHarmonicTransform(64, 32, dtype=torch.float64,
                                         device=dev, fft_impl='matmul')
        s = sht.analyze(to_torch(grid, device=dev))
        spec[str(dev)] = (s, sht.synthesize(s))
    for got, ref in zip(spec['cuda:0'], spec['cpu']):
        assert rel_err(got, ref) < 1e-12
    kw = dict(nlon=32, nlat=16, nz=10, rad_every=6, rad_col_chunk=128,
              dtype=torch.float32, fft_impl='matmul')
    out = {}
    for dev in ('cpu', cuda):
        _, init_fn, _, run_fn = build_moist_gcm(device=dev, **kw)
        carry, _ = run_fn(init_fn(0), 2)
        out[str(dev)] = carry_to_numpy(carry)[2]
    for key, tol in (('T', 0.01), ('u', 0.02), ('v', 0.02), ('ps', 15.0)):
        assert np.abs(out['cuda:0'][key] - out['cpu'][key]).max() < tol


@pytest.mark.gpu
def test_parmentier_optics_copy_no_state_field_to_the_host(cuda, band_count):
    """The Parmentier optics run on the card where JAX runs them in numpy
    on the host: under CUDA's sync debug mode 'error' no operation of
    theirs may wait for the card (a device-to-host copy does)."""
    from climt_tpu_torch.components.cork.lw import CorkLongwaveRadiation
    from torch_helpers import cork_columns
    comp = CorkLongwaveRadiation(optics='parmentier', device=cuda)
    c = {k: to_torch(v, device=cuda) for k, v in cork_columns(2).items()}
    comp.array_call(c)              # the coefficients reach the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        tau, planck_src, surf_src = comp._parmentier_optics(
            c['T'], c['p'], c['p_int'], c['T_surf'], c['T_irr'],
            c['T_int'], 5.670374e-8, 9.80665)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert tau.is_cuda and tau.shape == (2, 1, 28, 16)
    assert planck_src.is_cuda and surf_src.shape == (2, 1, 16)


@pytest.mark.gpu
def test_entry_points_run_on_the_card(cuda):
    """entry() builds on the card by default; its step is one radiation
    chunk of a refresh (6 kernel-B launches, 1 kernel-A); one m-sharded
    step of dryrun_multichip(1) on a spawned NCCL rank holds against one
    device."""
    from climt_tpu_torch import entry_points
    fn, (carry,) = entry_points.entry()
    counters = (fused_mix.mix_groups_cuda, rtrn_kernel.rtrn_lw_cuda)
    before = [c.launches for c in counters]
    spec = fn(carry)
    assert [c.launches - b for c, b in zip(counters, before)] == [6, 1]
    assert spec.is_cuda and spec.dtype == torch.complex64
    errors = entry_points.dryrun_multichip(1)
    assert max(e['of_limit'] for e in errors.values()) <= 1.0


# -- the LW k-table calibration: kernel B's backward ------------------------

# chip_smoke.py's limits, of max, by type name
BWD_TOL = smoke_constant('BWD_TOL')


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_kernel_b_backward_matches_plain(cuda, dtype):
    """mix_groups_bwd_cuda against mix_groups_bwd_plain on the ragged
    bands (9300 cells: a partial last tile) and on the LW taug group of
    512 columns at nz=28 (its largest band table 116 KB in float32, 232
    KB in float64); and through MixGroups, autograd
    on the card, against the plain backward.  Atomics add in a
    run-dependent order: the limits are chip_smoke.py's BWD_TOL."""
    tol = BWD_TOL[str(dtype).split('.')[1]]
    rng = np.random.RandomState(3)
    groups = [ragged_group(ragged_bands(cells=(31, 300)), dtype, cuda),
              port_taumol_groups(radiation_columns(nz=28, ncol=512), dtype,
                                 cuda)['lw_taug'].finish()]
    for layout, idx, w in groups:
        gout = to_torch(rng.randn(*idx.shape[1:], layout.width), dtype, cuda)
        before = fused_mix.mix_groups_bwd_cuda.launches
        got = fused_mix.mix_groups_bwd_cuda(layout, idx, w, gout)
        assert fused_mix.mix_groups_bwd_cuda.launches == before + 1
        ref = fused_mix.mix_groups_bwd_plain(layout, idx, w, gout)
        assert got.dtype == dtype and rel_err(got, ref) <= tol
        # a copy: the LW group's layout is the cached one of the installed
        # tables, which later LW calls must go on reading without a graph
        layout = copy.copy(layout)
        table = layout.table.detach().clone().requires_grad_(True)
        layout.table = table
        out = fused_mix.mix_groups(layout, idx, w)
        assert out.grad_fn is not None
        graded, = torch.autograd.grad(out, table, gout)
        assert fused_mix.mix_groups_bwd_cuda.launches == before + 2
        assert rel_err(graded, ref) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('case', CONTENTION_CASES)
def test_kernel_b_backward_contention_patterns(cuda, case, dtype):
    """mix_groups_bwd_cuda against mix_groups_bwd_plain within
    chip_smoke.py's BWD_TOL on each contention pattern of
    torch_helpers.contention_bands: every cell on one row, every cell on
    its own row, rows changing every 1, 4, 8 and 64 cells, indices past
    both ends of a table, one-row parts, bands of ng 1 to 16, float64
    bands of 256 KB and 1.1 MB (more than a block's shared memory), and
    ncell not a multiple of a tile (231), 1 and one column (28); one
    launch per call."""
    rng = np.random.RandomState(100 + CONTENTION_CASES.index(case))
    layout, idx, w = ragged_group(contention_bands(case), dtype, cuda)
    gout = to_torch(rng.randn(*idx.shape[1:], layout.width), dtype, cuda)
    before = fused_mix.mix_groups_bwd_cuda.launches
    got = fused_mix.mix_groups_bwd_cuda(layout, idx, w, gout)
    assert fused_mix.mix_groups_bwd_cuda.launches == before + 1
    ref = fused_mix.mix_groups_bwd_plain(layout, idx, w, gout)
    assert got.dtype == dtype and got.shape == ref.shape
    assert bool(ref.abs().max() > 0)
    assert rel_err(got, ref) <= BWD_TOL[str(dtype).split('.')[1]]


@pytest.mark.gpu
def test_calibration_loss_and_gradient_on_the_card_match_the_cpu(cuda):
    """The calibration loss on one training case (targets: the port's CPU
    fluxes at the calibrated parameters), the two anchors and the prior,
    at the prior, in float64: 3 kernel-B and 2 backward launches per LW
    call, no kernel A; value and gradient within 1e-10 and 1e-9 of the
    CPU's."""
    from climt_tpu_torch.components.rrtmg import lw_surrogate
    from climt_tpu_torch.tools import calibrate_lw_ktables as cal

    tables = lw_surrogate.build_tables(lw_surrogate.load_calibrated_params())
    family = cal.TRAIN[0]
    inputs, flags = cal.case_inputs(*family, device='cpu')
    tgt = cal.synthetic_targets(inputs, flags, tables)
    theta = lw_surrogate.default_params()
    out = {}
    for dev in ('cpu', cuda):
        args = ([(cal.case_inputs(*family, device=dev)[0], flags, tgt)],
                cal.tropical_inputs(device=dev),
                cal.tropical_inputs(co2_scale=2.0, device=dev),
                torch.as_tensor(theta, device=dev))
        counters = (fused_mix.mix_groups_cuda, fused_mix.mix_groups_bwd_cuda,
                    rtrn_kernel.rtrn_lw_cuda)
        before = [c.launches for c in counters]
        out[str(dev)] = cal.value_and_grad(torch.as_tensor(theta, device=dev),
                                           *args)
        launched = [c.launches - b for c, b in zip(counters, before)]
    assert launched == [9, 6, 0]
    (val, grad), (val_c, grad_c) = out['cuda:0'], out['cpu']
    assert abs(float(val) - float(val_c)) <= 1e-10 * abs(float(val_c))
    assert rel_err(grad, grad_c) <= 1e-9


@pytest.mark.gpu
def test_kernel_a_refuses_a_gradient(cuda):
    """A float32 LW call whose tables require grad reaches kernel A, which
    has no backward: it raises instead of returning detached fluxes."""
    from climt_tpu_torch.components.rrtmg import lw_surrogate
    theta = torch.as_tensor(lw_surrogate.default_params(),
                            dtype=torch.float32, device=cuda)
    tables = lw_surrogate.build_tables(theta.requires_grad_(True))
    with pytest.raises(NotImplementedError, match='kernel A'):
        port_lw(radiation_columns(nz=9, ncol=4), torch.float32, cuda,
                tables=tables)
    with torch.no_grad():
        port_lw(radiation_columns(nz=9, ncol=4), torch.float32, cuda,
                tables=tables)


@pytest.mark.gpu
def test_kernel_b_refuses_weights_that_require_grad(cuda):
    layout, idx, w = ragged_group(ragged_bands(), torch.float64, cuda)
    with pytest.raises(NotImplementedError, match='weights'):
        fused_mix.mix_groups(layout, idx, w.requires_grad_(True))
    with torch.no_grad():
        fused_mix.mix_groups(layout, idx, w)


# chip_smoke.py's limits, of max, by type name: the convection kernel
# keeps the plain version's arithmetic but for its sums over levels
CONVECTION_TOL = smoke_constant('CONVECTION_TOL')


# chip_smoke.py's capture of the moist GCM's emanuel_convect arguments
convection_inputs = smoke_constant('convection_inputs')


def _convection_calls(device, dtype, nz, calls):
    """The emanuel_convect arguments of the 32x16xnz moist GCM's calls
    ``calls`` (call n steps from the state after n steps)."""
    return convection_inputs(dict(nlon=32, nlat=16, nz=nz, rad_col_chunk=128),
                             dtype, calls, device)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype,nz', [(torch.float64, 10),
                                      (torch.float32, 10),
                                      (torch.float32, 28),
                                      (torch.float64, 28),
                                      (torch.float32, 32)])
def test_emanuel_kernel_matches_plain(cuda, dtype, nz):
    """At the GCM's start and after 6 steps: one launch a call, iflag
    equal, every output within CONVECTION_TOL of its largest value, and
    the same outputs from contiguous (ncol, nz) inputs as from the GCM's
    transposed ones."""
    for args in _convection_calls(cuda, dtype, nz, (0, 6)):
        before = E.emanuel_convect_cuda.launches
        out = E.emanuel_convect(*args)
        assert E.emanuel_convect_cuda.launches == before + 1
        ref = E.emanuel_convect_plain(*args)
        assert int((ref['iflag'] > 0).sum()) > 0
        assert torch.equal(out['iflag'], ref['iflag'])
        for key in ('ft', 'fq', 'fu', 'fv', 'precip', 'wd', 'tprime',
                    'qprime', 'cbmf', 'cape'):
            assert out[key].dtype == dtype
            if float(ref[key].abs().max()) > 0:
                assert rel_err(out[key], ref[key]) <= CONVECTION_TOL[
                    str(dtype).replace('torch.', '')]
            else:
                assert float(out[key].abs().max()) == 0.0, key
        flat = E.emanuel_convect(*[
            a.contiguous() if torch.is_tensor(a) else a for a in args])
        for key in out:
            assert torch.equal(flat[key], out[key]), key


@pytest.mark.gpu
def test_moist_gcm_step_launches_the_convection_kernel_once(cuda):
    _, init_fn, _, run_fn = build_moist_gcm(
        nlon=32, nlat=16, nz=10, dtype=torch.float32, device=cuda,
        rad_col_chunk=128)
    carry = init_fn(0)
    before = E.emanuel_convect_cuda.launches
    run_fn(carry, 3)
    assert E.emanuel_convect_cuda.launches == before + 3


@pytest.mark.gpu
def test_emanuel_kernel_refuses_a_gradient_on_the_card(cuda):
    args = _convection_calls(cuda, torch.float64, 10, (0,))[0]
    T = args[0].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match='backward'):
        E.emanuel_convect(T, *args[1:])
    with torch.no_grad():
        E.emanuel_convect(T, *args[1:])


@pytest.mark.gpu
def test_profile_step_ties_ctypes_launches_to_their_spans(cuda):
    """In a traced refresh step of the moist GCM every device operation
    counts under the span around its launch: the convection kernel's one
    launch under climt.convection, and none outside the program's spans,
    kernels A and B (launched through ctypes) included."""
    from climt_tpu_torch import profile_step
    _, init_fn, step_fn, run_fn = build_moist_gcm(
        nlon=32, nlat=16, nz=10, dtype=torch.float32, device=cuda,
        rad_col_chunk=128)
    carry, _ = run_fn(init_fn(0), 6)
    torch.cuda.synchronize()
    _, _, prof = profile_step.traced_step(step_fn, carry)
    rows = profile_step.layers(prof)
    _, launches, by_name = profile_step.kernel_summary(prof)
    assert rows['climt.convection'][2] == 1
    assert any('emanuel_kernel' in name for name in by_name)
    assert any('rtrn_lw_kernel' in name for name in by_name)
    assert profile_step.NO_SPAN not in rows
    assert sum(r[2] for r in rows.values()) == launches


# chip_smoke.py's limit, in epsilons of the type, of the term writer's
# power terms
TERM_POWER_EPS = smoke_constant('TERM_POWER_EPS')


def _assert_terms_match(report):
    for name, rec in report.items():
        assert rec['idx_mismatch'] == 0, (name, rec)
        assert rec['max_ulp'] == 0, (name, rec)
        assert rec['power_eps'] <= TERM_POWER_EPS, (name, rec)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('nz, ncol', [(28, 8192), (60, 32768)])
def test_term_writer_matches_its_plain_version(cuda, nz, ncol, dtype):
    """The term-writer kernel at a T85 chunk and at rrtmg_l60's call, on
    columns with and without a tropopause crossing and every gas varied,
    against its plain version (term_writer.taumol_terms_plain) on the CPU
    on the same coefficients: one launch a call, the multi-row indices
    equal, every weight equal but the adjusted minor-gas columns' power
    terms, within TERM_POWER_EPS of chip_smoke.py (the terms that differ
    are named in the report)."""
    for call in ('lw', 'sw'):
        before = TW.taumol_terms_cuda.launches
        report = term_writer_check(call, dtype, nz, ncol, cuda)
        assert TW.taumol_terms_cuda.launches == before + 1
        _assert_terms_match(report)
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('call, case', [
    ('lw', case) for case in LW_TABLE_CASES + ('wx_subset',)]
    + [('sw', mode) for mode in ('svar', 'band')])
def test_term_writer_cases_match_its_plain_version(cuda, call, case, dtype):
    """The kernel on LW tables without a minor-gas table and a fracref,
    with eta Planck fractions, with tables that require grad, on a subset
    of the cross-section gases, and in the SW solar modes svar and band,
    at 28 x 512, against its plain version on the CPU."""
    _assert_terms_match(term_writer_check(call, dtype, 28, 512, cuda, case))


@pytest.mark.gpu
def test_radiation_call_launches_the_term_writer_once(cuda):
    """An LW and an SW call on a T85 chunk: one term-writer launch each."""
    c = radiation_columns(nz=28, ncol=8192)
    before = TW.taumol_terms_cuda.launches
    port_lw(c, torch.float32, cuda)
    port_sw(c, torch.float32, cuda)
    assert TW.taumol_terms_cuda.launches == before + 2


@pytest.mark.gpu
def test_calibration_gradient_is_the_plain_term_writers(cuda, monkeypatch):
    """The calibration loss and its gradient on the card, the terms of the
    tables that require grad written by the term-writer kernel (one launch
    per LW call, on the first call of each table set too), against the same
    on the card with the terms written by its plain version
    (term_writer.taumol_terms_plain on CUDA tensors, no launch): kernel B's
    backward sees the same indices and weights, but for the power terms'
    ulps and the order of its atomics."""
    from climt_tpu_torch.components.rrtmg import lw_surrogate
    from climt_tpu_torch.tools import calibrate_lw_ktables as cal

    tables = lw_surrogate.build_tables(lw_surrogate.load_calibrated_params())
    family = cal.TRAIN[0]
    inputs, flags = cal.case_inputs(*family, device='cpu')
    tgt = cal.synthetic_targets(inputs, flags, tables)
    theta = torch.as_tensor(lw_surrogate.default_params(), device=cuda)
    args = ([(cal.case_inputs(*family, device=cuda)[0], flags, tgt)],
            cal.tropical_inputs(device=cuda),
            cal.tropical_inputs(co2_scale=2.0, device=cuda), theta)
    before = TW.taumol_terms_cuda.launches
    val, grad = cal.value_and_grad(theta, *args)
    assert TW.taumol_terms_cuda.launches - before == 3
    monkeypatch.setattr(TW, 'taumol_terms', TW.taumol_terms_plain)
    before = TW.taumol_terms_cuda.launches
    val_p, grad_p = cal.value_and_grad(theta, *args)
    assert TW.taumol_terms_cuda.launches == before
    assert abs(float(val) - float(val_p)) <= 1e-12 * abs(float(val_p))
    assert rel_err(grad, grad_p) <= 1e-10
