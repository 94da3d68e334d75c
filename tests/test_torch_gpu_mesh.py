"""climt_tpu_torch's mesh layouts across CUDA cards, one NCCL rank per
card, each held to the same model on one card.

Every test here needs two or more CUDA cards and skips itself elsewhere,
saying how many the machine has.  The file imports neither jax nor
climt_tpu, so on a machine with the cards and without jax it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu_mesh.py

The ranks are spawned once for the file (``torch_helpers.card_mesh_rank``,
rank r on card r, NCCL between the cards).  Each rank runs

- the m-sharded moist GCM (``build_moist_gcm(mesh=...)``) with spectral,
  FV and SL moisture on the (n, 1) mesh, and on (2, 2) where n = 4;
- the replicated-spectral layout (``shard_model_state``) of the moist GCM
  in the three modes and of Held-Suarez, on every mesh of
  ``torch_helpers.LAYOUTS`` where n = 4 ((n, 1), and (1, n) with
  ``shard_lon``, otherwise);

each at 64x32x10 float64 for 7 steps, held to the same model on the
rank's own card (every field within ``CARD_SMALL_TOL`` of max), and at
T85 float32 (256x128x28, ``rad_col_chunk=8192``) for one radiation
refresh step from the one-card model's initial carry, held to one card
within ``entry_points.compare_steps``'s float32 limits
(__graft_entry__.py:101-109).  A float32 refresh is not continuous at
roundoff (RRTMG's table lookups): the m-sharded model's own initial
state, the one-card state to roundoff, moved the refresh's surface
radiation past those limits, so at T85 the m-sharded model starts from
the one-card carry cut by ``carry_to_rank``, as the replicated layout
starts from it through ``shard_model_state``, and its own initial carry
is held to the one-card one within the same limits.  The first step of each makes the collectives the CPU's gloo ranks make
(``torch_helpers.STEP_COLLECTIVES``), and each T85 refresh launches
kernel B and kernel A as often as the radiation's column chunks say
(``torch_helpers.refresh_launches``); FV's tracer mass is conserved and
the water fixer closes on every rank (``conservation_failures``, as the
CPU files check).  The checks are ``torch_helpers.card_mesh_failures``, which
``chip_smoke.py`` phase 28 runs too.
"""

import pytest
import torch

from torch_helpers import CARD_TIMEOUT, card_mesh_failures, spawn_ranks


@pytest.fixture(scope='module')
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip('needs 2 or more CUDA cards, one NCCL rank each; this '
                    'machine has %d' % n)
    return n


@pytest.fixture(scope='module')
def ranks(cards, tmp_path_factory):
    """Every rank's records of torch_helpers.card_mesh_rank."""
    return spawn_ranks('card_mesh_rank', cards,
                       tmp_path_factory.mktemp('card_mesh'),
                       timeout=CARD_TIMEOUT, device='cuda')


def _assert_none(failures):
    assert not failures, '\n'.join(failures)


@pytest.mark.gpu
@pytest.mark.parametrize('mode', ['spectral', 'fv', 'sl'])
def test_m_sharded_model_matches_one_card(ranks, cards, mode):
    _assert_none(card_mesh_failures(ranks, cards, 'answers', 'm_sharded',
                                    mode))


@pytest.mark.gpu
@pytest.mark.parametrize('model', ['spectral', 'fv', 'sl', 'held_suarez'])
def test_replicated_layout_matches_one_card(ranks, cards, model):
    _assert_none(card_mesh_failures(ranks, cards, 'answers', 'replicated',
                                    model))


@pytest.mark.gpu
def test_one_step_makes_the_cpus_collectives(ranks, cards):
    _assert_none(card_mesh_failures(ranks, cards, 'collectives'))


@pytest.mark.gpu
def test_each_refresh_launches_the_kernels_of_its_chunks(ranks, cards):
    _assert_none(card_mesh_failures(ranks, cards, 'launches'))


@pytest.mark.gpu
def test_fv_mass_is_conserved_and_the_water_fixer_closes(ranks, cards):
    _assert_none(card_mesh_failures(ranks, cards, 'conservation'))


@pytest.mark.gpu
def test_every_case_ran_on_every_rank(ranks, cards):
    """Each rank holds a record of every case: 2 sizes x (3 modes x the
    m-sharded meshes + 4 models x the layouts)."""
    _assert_none(card_mesh_failures(ranks, cards, 'complete'))
