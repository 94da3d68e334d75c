"""The program's spans (``climt_tpu_torch.utils.profiling.phase``) in a
CPU profile of the moist GCM's steps at 32x16x10 (the model of
tests/test_torch_moist_gcm.py): where each opens, how they nest, which
steps and modes open which, and that with no profiler active a span is a
no-op that leaves the step's numbers bit-identical."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
from climt_tpu_torch.profile_step import world_of_one
from climt_tpu_torch.utils import profiling

KW = dict(nlon=32, nlat=16, nz=10, rad_every=6, rad_col_chunk=128)
CHUNKS = 32 * 16 // 128
RADIATION = {'climt.radiation', 'climt.gas_optics', 'climt.lw_sweep',
             'climt.sw_solver'}


def spans_of(fn):
    """(fn's result, [(name, start ns, end ns)] of its program spans)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name(), e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith('climt.')]


def named(spans, name):
    return [s for s in spans if s[0] == name]


def inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


# the models of the cases: each moisture mode, and spectral moisture with
# the water fixer off
BUILDS = {'spectral': {}, 'fv': dict(moisture_advection='fv'),
          'sl': dict(moisture_advection='sl'),
          'no_fixer': dict(conserve_water=False)}


@pytest.fixture(scope='module')
def models():
    return {name: build_moist_gcm(dtype=torch.float32, device='cpu',
                                  **kw, **KW)
            for name, kw in BUILDS.items()}


def step_spans(models, mode, k):
    """The spans of step k (0 a radiation refresh, 1 a plain step)."""
    _, init_fn, step_fn, _ = models[mode]
    carry = init_fn(0)
    for _ in range(k):
        carry, _ = step_fn(carry)
    return spans_of(lambda: step_fn(carry))[1]


def check_refresh_nests(spans):
    step, = named(spans, 'climt.step')
    physics, = named(spans, 'climt.physics')
    radiation, = named(spans, 'climt.radiation')
    assert inside(physics, step) and inside(radiation, physics)
    # two gas optics (LW, SW), one LW sweep and one SW solver a chunk
    counts = {n: len(named(spans, n)) for n in RADIATION}
    assert counts == {'climt.radiation': 1, 'climt.gas_optics': 2 * CHUNKS,
                      'climt.lw_sweep': CHUNKS, 'climt.sw_solver': CHUNKS}
    for name in RADIATION - {'climt.radiation'}:
        assert all(inside(s, radiation) for s in named(spans, name))
    # per chunk: LW gas optics, LW sweep, SW gas optics, SW solver
    order = [s[0] for s in sorted(spans, key=lambda s: s[1])
             if s[0] in RADIATION - {'climt.radiation'}]
    assert order == ['climt.gas_optics', 'climt.lw_sweep',
                     'climt.gas_optics', 'climt.sw_solver'] * CHUNKS
    convection, = named(spans, 'climt.convection')
    dynamics, = named(spans, 'climt.dynamics')
    assert inside(convection, physics) and inside(dynamics, step)
    assert dynamics[1] >= physics[2]


def check_plain_has_no_radiation(spans):
    names = {s[0] for s in spans}
    assert not names & RADIATION
    assert {'climt.step', 'climt.physics', 'climt.convection',
            'climt.dynamics'} <= names


def check_transport(spans, transport, fixer):
    step, = named(spans, 'climt.step')
    dynamics, = named(spans, 'climt.dynamics')
    moved = named(spans, 'climt.transport')
    fixed = named(spans, 'climt.fixer')
    assert bool(moved) == transport and len(fixed) == fixer
    assert all(inside(s, dynamics) for s in moved)
    assert all(inside(s, step) and s[1] >= dynamics[2] for s in fixed)


CASES = {
    'refresh_nests_radiation_in_every_chunk':
        ('spectral', 0, check_refresh_nests),
    'plain_step_opens_no_radiation':
        ('spectral', 1, check_plain_has_no_radiation),
    'spectral_fixer_no_transport':
        ('spectral', 1, lambda s: check_transport(s, False, 1)),
    'fv_transport_no_fixer':
        ('fv', 1, lambda s: check_transport(s, True, 0)),
    'fv_refresh_transport_no_fixer':
        ('fv', 0, lambda s: check_transport(s, True, 0)),
    # SL moisture: the transport inside the dynamics, then the fixer
    'sl_fixer_no_transport':
        ('sl', 1, lambda s: check_transport(s, True, 1)),
    'fixer_off_no_fixer_span':
        ('no_fixer', 1, lambda s: check_transport(s, False, 0)),
}


@pytest.mark.parametrize('case', list(CASES))
def test_spans_of_a_step(case, models):
    mode, k, check = CASES[case]
    check(step_spans(models, mode, k))


def test_the_placed_carry_steps_in_collective_spans():
    from climt_tpu_torch.parallel import shard_model_state
    _, init_fn, step_fn, _ = build_moist_gcm(dtype=torch.float32,
                                             device='cpu', **KW)
    with world_of_one(device='cpu') as mesh:
        carry = shard_model_state(mesh, *init_fn(0))
        spans = spans_of(lambda: step_fn(carry))[1]
    outer, twin = sorted(named(spans, 'climt.step'), key=lambda s: s[1])
    assert inside(twin, outer)
    collectives = named(spans, 'climt.collective')
    fixer, = named(spans, 'climt.fixer')
    assert collectives and all(inside(s, twin) for s in collectives)
    assert any(inside(s, fixer) for s in collectives)


def test_phase_without_a_profiler_records_nothing():
    span = profiling.phase('climt.unseen')
    assert isinstance(span, contextlib.nullcontext)
    assert profiling.phase('climt.other') is span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span:
            torch.ones(4).sum()
        with profiling.phase('climt.seen'):
            torch.ones(4).sum()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert 'climt.seen' in names and 'climt.unseen' not in names


@pytest.mark.parametrize('mode', ['spectral', 'fv'])
def test_spans_leave_the_step_bit_identical(mode, models):
    """A refresh and a plain step, untraced (every span a no-op) and
    traced (every span recorded), from one carry: the same bits."""
    _, init_fn, step_fn, run_fn = models[mode]
    carry = init_fn(0)
    plain, plain_diag = run_fn(carry, 2)
    traced, traced_diag = spans_of(lambda: run_fn(carry, 2))[0]
    flat = (torch.utils._pytree.tree_leaves((plain, plain_diag)),
            torch.utils._pytree.tree_leaves((traced, traced_diag)))
    assert len(flat[0]) == len(flat[1])
    for a, b in zip(*flat):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_profile_step_layers_split_the_step_among_its_spans(models):
    from climt_tpu_torch import profile_step
    _, init_fn, step_fn, _ = models['spectral']
    carry = init_fn(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step_fn(carry)
    rows = profile_step.layers(prof)
    step, = [e for e in prof.events() if e.name == 'climt.step']
    assert set(rows) == {'climt.step', 'climt.physics', 'climt.convection',
                         'climt.radiation', 'climt.gas_optics',
                         'climt.lw_sweep', 'climt.sw_solver',
                         'climt.dynamics', 'climt.fixer'}
    assert rows['climt.gas_optics'][0] == 2 * CHUNKS
    assert all(r[1] >= 0.0 and r[2] == 0 for r in rows.values())
    assert sum(r[1] for r in rows.values()) == pytest.approx(
        step.time_range.elapsed_us() / 1e3, rel=1e-9)


def test_reset_collectives_zeroes_every_counter():
    from climt_tpu_torch import profile_step
    for counter in profile_step.COLLECTIVES.values():
        counter.calls, counter.bytes = 3, 96
    assert profile_step.collectives()['halo'] == (3, 96)
    profile_step.reset_collectives()
    assert set(profile_step.collectives().values()) == {(0, 0)}
