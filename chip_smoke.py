#!/usr/bin/env python3
"""Smoke run of climt_tpu_torch, the PyTorch + CUDA port, on one GPU.

    python3 chip_smoke.py

Phases, each of which fails loudly (no exception is turned into exit 0):
  1. require a CUDA device; print the card's name and power limit; check
     that float32 matmuls run in full float32 (TF32 off);
  2. build the CUDA kernels of climt_tpu_torch/csrc/ with nvcc, one
     process per source;
  3. kernel B (band-fused gather-sum): the one-table synthetic case, then
     the six float32 groups that one T85 radiation chunk launches (nz=28,
     the first 8192 columns of the T85 initial state), then the six
     float64 groups of the first radiation call of
     examples/full_radiation_gcm_energy_balanced.py at its own 128x62x28
     (28 x 7936 cells), each against its plain version, timed beside its
     bound and F.embedding_bag per band;
  4. kernel A (LW flux integration) against its plain version, with
     clouds, at nz=28 and nz=60, ncol=8192, timed beside its bound;
  5. the moist GCM at 32x16x10, float32, 7 steps on the GPU against the
     same model on the CPU (plain versions);
  6. the moist GCM at T85 (256x128x28, dt 600 s, rad_every=6,
     rad_col_chunk=8192), 12 steps through build_moist_gcm's step_fn,
     with the kernels' launch counts read around that run: it fails if a
     radiation refresh launches kernel B more than 40 times, or if a step
     does not launch the convection kernel exactly once;
  7. standalone LW+SW radiation at nz=60, ncol=8192, in columns/s;
  8. the fused Held-Suarez model at bench.py's T42 (128x64x28, f32, dt
     600 s), 1000 steps after one warm-up step, in s/step and
     gridpoint-steps/s, with peak memory;
  9. the Held-Suarez climatology of tests/test_dycore_multistep.py
     (64x32x20, dt 1200 s, f64, 30 days = 2160 steps) and that file's
     three checks: physical bounds, global mean surface pressure within
     500 Pa of 1e5, a westerly jet aloft in midlatitudes;
 10. examples/held_suarez.py, its text with climt_tpu replaced by
     climt_tpu_torch (``import climt_tpu_torch as ct``) and verbose=False:
     128x64x20, 96 calls of 15 min on the card, timed per call; then 8
     calls at 32x16x10 on the CPU and on the card, held against each other
     at float64;
 11. examples/full_radiation_gcm_energy_balanced.py the same way at its
     own 128x62x28, float64, dt 600 s, 13 calls (RRTMG refreshed at calls
     0, 6 and 12 through UpdateFrequencyWrapper): s/call of refresh and
     other calls, peak memory, both kernels' launches per refresh (kernel
     B float64 must run, kernel A must not), every field finite, T in
     (150, 350) K;
 12. the same example at 16x8x8 for 7 calls on the card against the CPU,
     within 10 times the spread that a one-ulp change of the initial
     temperature makes on the CPU;
 13. examples/full_radiation_with_insolation_gcm.py (Instellation every
     call, RRTMG refreshed at calls 0, 6 and 12) the same way at its own
     128x62x28, float64, dt 600 s, 13 calls: s/call of refresh and other
     calls, the Instellation call's time, peak memory, 6 kernel-B and 0
     kernel-A launches per refresh, every field finite, T in (150, 350) K,
     a zenith angle that changes from call to call; then at 16x8x8 for 7
     calls on the card against the CPU under phase 12's one-ulp rule;
 14. examples/baroclinic_wave.py (the dry dycore from the DCMIP initial
     state) at its own 128x64x20, 100 calls, and
     examples/grey_radiative_convective.py (grey radiation, slab surface,
     dry convection, condensation) at its own nz=30, 100 steps, each timed
     on the card and held against the CPU under the one-ulp rule;
 15. the land-surface stack on one 128x64x28 float64 state: LandMask
     (with topography), DataOcean with and without compute_fluxes,
     SecondBEST and BucketHydrology (one and two layers) over the land
     columns, SeaIce over a polar band of sea ice and LandIce over the land
     and land-ice columns, SimpleBoundaryLayer and BergerSolarInsolation,
     each called 10 times on the card (ms per call) and on the CPU, under
     the one-ulp rule with a floor of 16 float64 epsilons;
 16. the grid-space transport operators FVAdvection and SLAdvection on the
     T85 grid (256x128x28) in float32 and float64, on the winds, layer
     thicknesses, mass fluxes and moisture of the FV moist GCM after its
     first step: ms per advect call (median of 20), launches per call, FV's
     zonal bands and band-substeps; float64 on the card against the CPU
     under the one-ulp rule; a uniform field kept and FV's tracer mass
     conserved on the card;
 17. the moist GCM with moisture_advection='fv' and 'sl' at phase 6's T85,
     12 steps each through build_moist_gcm: s/step, finite fields, T in
     (150, 350) K, kernel B 24 and kernel A 4 launches per refresh; then
     both at 64x32x10 for 7 steps on the card against the CPU within
     SMALL_TOL;
 18. GFSDynamicalCore with FV moisture and two registered tracers at
     128x64x20 float64 for 20 calls (s per call, the uniform tracer kept
     to 1e-10), then at 32x16x10 on the card against the CPU under the
     one-ulp rule;
 19. the ten examples of tests/test_torch_examples_*.py that run on the
     card, at tests/test_examples.py's sizes, each on the card against the
     CPU under the one-ulp rule; then a 128x64x28 float64 state on the
     card stored through NetCDFMonitor (the native writer,
     write_on_store=True) and RestartMonitor, ms per store, the file and
     the restart read back equal to the card's fields;
 20. the parallel layer (climt_tpu_torch/parallel/), last: (a) one NCCL
     rank in this process, the T85 moist GCM of phase 6 built with
     build_moist_gcm(mesh=make_mesh(1)), float32, with spectral and with
     FV moisture: one step against the single-device model within the
     float32 limits of __graft_entry__.py's dryrun_multichip, then 12
     steps timed with exactly 24 kernel-B and 4 kernel-A launches per
     refresh, the all_to_all transposes and halo calls per step, and the
     kernel launches of a refresh step and a plain step beside the
     single-device model's; the process group is destroyed after it;
     (b) two spawned ranks sharing the card over gloo (NCCL refuses two
     ranks on one GPU), the moist GCM at 64x32x10 float64, 7 steps with
     spectral moisture (gloo refuses the FV halo's CUDA point-to-point
     sends), each rank's gathered carry within 1e-9 of max of the
     single-device card run;
 21. the replicated-spectral layout (parallel.shard_model_state): (a) one
     NCCL rank, the T85 moist GCM of phase 6 built without a mesh, its
     carry placed on make_mesh(1) with shard_lon False and True and
     stepped by the model's own step_fn: one step against the
     single-device step within phase 20's float32 limits, then windows of
     12 steps (one device, replicated, replicated with shard_lon,
     m-sharded, one device) with exactly 24 kernel-B and 4 kernel-A
     launches per refresh, the all_reduce and all_gather calls per step,
     median s/step of each model, and the launches and kernel time of a
     refresh and a plain step of each replicated layout; (b) two spawned
     gloo ranks sharing the card, the moist GCM at 64x32x10 float64 with
     spectral and FV moisture (FV gathers its fields under shard_lon),
     on meshes (2, 1) and (1, 2) with shard_lon=True, 7 steps, each
     rank's gathered carry within 1e-9 of max of the single-device card
     run;
 22. examples/grey_gcm.py (32x16x8, 2 steps) and
     examples/radiative_heating_rrtmg_clouds.py with verbose=True on the
     card: their printouts read card fields with np.asarray;
 23. CORK longwave radiation (climt_tpu_torch.components.cork.lw): every
     shipped LW k-table at its own band and g-point count, and the
     Parmentier optics (irradiation 1200 K, internal 100 K), on one
     128x64x28 float64 state with a lapse-rate temperature, humidity,
     cloud and emissivity below 1: ms per call over 5 calls after a
     warm-up, device operations per call, every field finite and every
     flux non-negative; earth_low_res_lw at T85 (256x128x28) with
     diagnostics_level 0 and 1: s per call and peak memory; each case at
     16x8x8 on the card against the CPU under phase 12's one-ulp rule with
     phase 15's floor; neither kernel launches;
 24. the matmul zonal DFT (fft_impl='matmul'): phase 6's T85 model built
     with it, one step against phase 6's fft model within phase 20's
     float32 limits, then 12-step windows alternating with the fft model
     (exactly 24 kernel-B and 4 kernel-A launches per refresh, s/step);
     at 64x32x10 float64, 7 steps on the card against the CPU within
     SMALL_TOL; phase 21 (a)'s replicated layout with it, one step;
 25. installed LW k-tables: the surrogate's tables with every absorption
     array times exp(0.3 N(0, 1)) from seed 0 (tests/torch_helpers.py:
     seeded_lw_tables), written to a temporary directory and installed
     with load_aer_tables.  (a) kernel B's LW taug and fracs groups of
     phase 3's T85 chunk (float32) and of the full-radiation example's
     first call (float64) on those tables against the plain version
     (1e-6 and 1e-12 of max), timed beside phase 3's surrogate numbers,
     and the time of the first call after the install (the repack);
     (b) one T85 refresh step of phase 6's model: exactly 24 kernel-B and
     4 kernel-A launches, every field finite, T in (150, 350) K, OLR and
     the LW heating apart from the surrogate step's; (c) RRTMGLongwave at
     16x8x8 on the card against the CPU under phase 12's one-ulp rule
     (floor SPREAD_FLOOR); (d) the override removed: the T85 chunk's LW
     fluxes and the 16x8x8 component's outputs equal the pre-install
     ones bitwise, and the cached layouts are the surrogate's again;
 26. the repository's entry points on the port
     (climt_tpu_torch.entry_points): (a) entry() with no arguments builds
     the flagship step (the moist GCM at 32x16x10 float32) on the card
     and runs fn once: a finite complex64 CUDA spectral temperature, T in
     grid space in (150, 350) K, exactly 6 kernel-B and 1 kernel-A
     launches (one radiation chunk of a refresh step), added to the kernel
     lines; then the inputs of each launch of a third step, captured
     where the dispatchers call the wrappers: kernel B on its six groups
     within 1e-6 and kernel A (nz 10, 512 columns) within 2e-6 of max of
     their plain versions, timed, their errors folded into the kernel
     lines; (b) that step against entry(device='cpu')'s within
     SMALL_TOL['T']; (c) dryrun_multichip(1) on the card (one spawned
     NCCL rank, after any process group left running here is torn down):
     one m-sharded step at 8x4x8 against one device, each field's error
     beside its limit, and dryrun_multichip(n) when the machine has n > 1
     cards; (d) each call's time (fn twice: the first call and a warm
     one) beside the card's name and power limit;
 27. the LW k-table calibration (climt_tpu_torch.tools.calibrate_lw_ktables)
     on the card: (a) the gradient in theta of taumol_lw on phase 3's T85
     chunk with float32 tables built from the calibrated theta (exactly 2
     backward launches, finite and nonzero); the backward kernel's
     registers and spills in each type from the build log (it fails on a
     spill); kernel B's backward (csrc/mix_rows_bwd.cu) on the lw_taug
     and lw_fracs groups of that call (float32), of the full-radiation
     example's first call (float64) and of one calibration column (the
     tropical anchor, float64) with a seeded upstream gradient, against
     its plain version (2e-5 and 1e-13 of max), timed beside its bound and
     torch.autograd.grad of F.embedding_bag per band, and the difference
     between two runs; (b)
     the calibration loss on the tool's four training cases (targets made
     by the port on the CPU at the calibrated parameters), the two
     tropical anchors and the prior, at the prior parameters: value and
     gradient on the card against the CPU (1e-10 and 1e-9 of max), with
     exactly 3 kernel-B and 2 backward launches per LW call and no kernel
     A; (c) 20 Adam steps on the card from the prior: s/step, launches per
     step, the loss falls; (d) a float32 LW call whose tables require grad
     raises at kernel A, and kernel B refuses weights that require grad;
 28. the mesh layouts across the machine's cards, one NCCL rank per card
     (tests/torch_helpers.py:card_mesh_rank, the cases of
     tests/test_torch_gpu_mesh.py), on 2 or more cards: the m-sharded
     moist GCM with spectral, FV and SL moisture on (n, 1), and on (2, 2)
     where n = 4, and the replicated-spectral layout of the moist GCM in
     the three modes and of Held-Suarez (on 4 cards every layout of
     torch_helpers.LAYOUTS), at 64x32x10 float64 for 7 steps against the
     same model on the rank's own card (1e-9 of max) and at T85 float32
     for one refresh step (compare_steps's float32 limits), FV's halo
     exchanged point to point between the cards; each first step's
     collectives equal the CPU's, each T85 refresh launches kernel B and
     A as often as its column chunks say, FV's mass is conserved and the
     water fixer closes; then T85 float32 s/step of the m-sharded model
     and of the replicated layout with and without shard_lon, spectral
     and FV moisture, in 12-step windows alternating with the one-card
     model (medians), with each step's collectives, the bytes handed to
     them and, from one traced refresh and one plain step, the NCCL
     kernels' share of the device time and their overlap with other
     kernels, beside each card's name and power limit.  On one card it
     prints that it needs 2 or more cards and does not fail;
 30. (run after phase 4) the term-writer kernel (csrc/taumol_terms.cu) at
     rrtmg_l60's 60 x 32768 and at a T85 chunk, float32: each LW and SW
     call against its plain version on the CPU (TERM_POWER_EPS), one
     launch a call, device ms beside its byte bound, host ms a call and
     the plain version's ms on the card; phase 6 fails unless the T85
     steps launch it twice a radiation chunk;
 29. (run after phase 6) the convection kernel (csrc/emanuel.cu) on the
     emanuel_convect calls of the moist GCM: at T85 float32 after 6 and
     36 steps, and at 32x16x10 float64 at the start and after 6 steps;
     one launch a call by its counter and by the profiler, iflag equal on
     99.9% of the columns, every output within CONVECTION_TOL of max of
     the plain version's, and the kernel's time beside its bound
     (EMANUEL_OPS) and the plain version's.
The examples run through tests/torch_helpers.py:port_example, which the
CPU tests use too.
The line before the last is a JSON object with each kernel's launches
(the backward's float32 entry counts (a)'s taumol gradient, the
convection kernel's phase 6's steps),
error, time, bound, plain and library times; the last line is
{"ok": true, "device": {...}}.
It imports neither jax nor climt_tpu.
"""

import contextlib
import datetime
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T85 = dict(nlon=256, nlat=128, nz=28, timestep=600.0, rad_every=6,
           rad_col_chunk=8192)
T85_STEPS = 12
# phase 5 bounds, GPU float32 vs CPU float32 after 7 steps at 32x16x10.
# The port's own float32-vs-float64 gap there is 2e-4 K, 4e-4 m/s,
# 1.1e-7 kg/kg and 0.32 Pa; the bounds leave 50x room for the other
# summation order and transcendental roundoff of the card.
SMALL_TOL = dict(T=0.01, u=0.02, v=0.02, q=5e-6, ps=15.0)
# H100 SXM peaks (NVIDIA's data sheet): device memory bytes/s and
# float32 and float64 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12
# kernel A's float32 operations per (g, layer, column), both sweeps: the
# layer terms (about 30 with the cloudy branch) and the two recurrences
# (about 6), twice, plus the exp
RTRN_OPS_PER_POINT = 80
B_LAUNCHES_PER_REFRESH_MAX = 40
# phase 29: the kernel keeps the plain version's arithmetic operation by
# operation; only its sums over levels (the cloud-base buoyancy, the
# mixing-rate and weight normalisations, the entrained fluxes, amp1 and
# ad, the conservation fix) run in another order, a few ulps of each sum
# that the fluxes' cancellations can raise to some hundred ulps of the
# largest value
CONVECTION_TOL = {'float32': 2e-5, 'float64': 1e-12}
# operations of the convection kernel (csrc/emanuel.cu), counted from its
# body: each floating-point add, subtract, multiply, division, comparison,
# min, max, abs, sqrt, exp, log and pow is one operation; a level
# recurrence, run by every lane on shuffled values, counts once per level,
# and a warp sum as the adds of one lane; a branch taken only on some
# cells (pass 1's second try of sij, the downdraft's surface ramp) is left
# out, so this is a floor.  Every column: 151 per level (profiles 31,
# lifted parcel and its two Newton steps 91, efficiencies, CAPE and the
# closure 23, the three level searches 6) and 70 per column (LCL, the
# parcel's origin values, the closure).  A convecting column besides: 250
# per level (mixing rates, scrit and bf2 43, the downdraft 81, tendencies,
# the spread at inb and the conservation fix 126), 86 per (i, j) cell of
# the mixing matrix (pass 1 23, pass 2 21, pass 3 9, pass 4 30 with its
# five sums over i, amp1 and ad 3), 7 more per cell above the diagonal
# (the unsaturated-descent water) and 91 per column
EMANUEL_OPS = dict(level=151, column=70, active_level=250, cell=86,
                   upper_cell=7, active_column=91)
T42 = dict(nlon=128, nlat=64, nz=28, timestep=600.0)
T42_STEPS = 1000
# phase 10: 8 calls of the component API at 32x16x10, GPU float64 against
# CPU float64, max abs difference over max abs value of each output field;
# on the CPU the port matches the JAX package to 1e-10 of max over 5 calls
# (tests/test_torch_held_suarez.py), and the card differs from the CPU
# only in summation order
EXAMPLE_TOL = 1e-9
FULL_RADIATION = 'full_radiation_gcm_energy_balanced'
FULL_RADIATION_CALLS = 13
INSOLATION = 'full_radiation_with_insolation_gcm'
BAROCLINIC = 'baroclinic_wave'
GREY = 'grey_radiative_convective'
EXAMPLE_CALLS = 100
LAND_SIZE = (128, 64, 28)
LAND_CALLS = 10
# phase 15's floor under the one-ulp spread: LandMask's and
# BergerSolarInsolation's outputs come from the coordinates and the time
# alone, which the nudge leaves as they are, so their spread is 0; the
# card's float64 sin, cos and acos differ from the CPU's by a few ulps,
# which acos amplifies near the subsolar point (4e-15 of max measured on
# the H100)
SPREAD_FLOOR = 16 * 2.220446049250313e-16
# phase 16: the transport interval (2 dt of phase 6's model), FV's zonal
# bands and band-substeps on the T85 grid at that interval, and the
# limits on a uniform field and on FV's tracer mass per dtype
TRANSPORT_DT = 1200.0
T85_ZONAL = (13, 253)
TRANSPORT_REPS = 20
UNIFORM_TOL = {'float32': 1e-6, 'float64': 1e-12}
MASS_TOL = {'float32': 1e-5, 'float64': 1e-12}
GRID_MODES = ('fv', 'sl')
# phase 20: the moisture modes of the world of one, and
# __graft_entry__.py:101-109's float32 limits of an m-sharded step against
# the single-device one (fields; radiation fluxes in aux)
MESH_MODES = ('spectral', 'fv')
MESH_FIELD_TOL = dict(rtol=2e-4, atol=1e-5)
MESH_AUX_TOL = dict(rtol=5e-4, atol=5e-3)
# phase 20 (b): two ranks sharing the card, against one device; the mesh
# changes only the order of the transforms' and the fixer's sums.  gloo
# refuses CUDA tensors in point-to-point sends (the FV halo's
# batch_isend_irecv), so they run spectral moisture only (PERF.md
# section 7)
SHARED_CARD = dict(nlon=64, nlat=32, nz=10, rad_every=6, rad_col_chunk=2048)
SHARED_CARD_MODES = ('spectral',)
SHARED_CARD_TOL = 1e-9
# phase 21 (b): two ranks sharing the card in the replicated-spectral
# layout, against one device; both meshes shard longitude, so FV moisture
# gathers its fields and sends nothing point to point
LAYOUT_CARD = dict(nlon=64, nlat=32, nz=10, rad_every=6, rad_col_chunk=2048)
LAYOUT_CARD_MESHES = (((2, 1), True), ((1, 2), True))
LAYOUT_CARD_MODES = ('spectral', 'fv')
LAYOUT_CARD_TOL = 1e-9
# phase 22: the examples run with verbose=True, and their keyword
# arguments (tests/test_examples.py's sizes)
VERBOSE_EXAMPLES = (('grey_gcm', dict(n_steps=2, nx=32, ny=16, nz=8)),
                    ('radiative_heating_rrtmg_clouds', {}))
# phase 23: the shipped LW k-tables and the Parmentier optics, the state
# sizes (nx, ny, nz) and the timed calls
CORK_CASES = ('earth_low_res_lw', 'earth_low_res_lw_4band_ngpt2_before',
              'mars_lw', 'single_band_gray_lw', 'single_band_unit_lw',
              'test_2band_lw', 'titan_lw', 'tour_gray_lw',
              'trappist1e_hab1_lw', 'trappist1e_hab2_lw', 'venus_lw',
              'parmentier')
CORK_SIZE = (128, 64, 28)
CORK_T85 = (256, 128, 28)
CORK_SMALL = (16, 8, 8)
CORK_CALLS = 5
# phase 24: one float32 step with the matmul DFT may lie at most
# MATMUL_RATIO times as far from the float64 model as the fft model's
# (floored at one float32 epsilon of max)
MATMUL_RATIO = 10.0
# phase 25: RRTMGLongwave's card-against-CPU size
KTABLE_SMALL = (16, 8, 8)
# phase 27: kernel B's backward adds with atomics, in an order that
# changes from run to run, where the plain version adds in index order:
# limits of max for each type, about 10x the largest error measured on
# the LW groups (1.5e-6 and 4.2e-15 on an H100 80GB HBM3 at 700 W); the
# calibration's loss and gradient on the card against the CPU; the Adam
# steps taken on the card
BWD_TOL = {'float32': 2e-5, 'float64': 1e-13}
# the term-writer kernel against its plain version on the CPU: indices and
# weights equal but those of the adjusted minor-gas columns' power terms,
# whose relative difference stays within this many epsilons of the type:
# the two powers differ by up to three ulps (CUDA's pow is within two of
# the exact power, SLEEF's on the CPU within one; the float32 kernel
# rounds the float64 pow, within half an ulp), and each of the five
# roundings after it (a sum, three products, the lin weight) can move the
# two results one more epsilon apart
TERM_POWER_EPS = 8
CALIBRATION_TOL = dict(value=1e-10, grad=1e-9)
ADAM_STEPS = 20
FLOAT32_EPS = 2.0 ** -23
# phase 17's card-against-CPU size
GRID_SMALL = dict(nlon=64, nlat=32, nz=10, rad_every=6, rad_col_chunk=2048)
# phase 18: the two registered tracers, a blob and a uniform field
TRACER_SIZE, TRACER_CALLS = (128, 64, 20), 20
TRACERS = ('tracer_blob', 'tracer_uniform')
UNIFORM_TRACER = 0.5
# phase 19: the examples that run on the card, with their dycore calls,
# the keyword arguments of tests/test_examples.py and where the one-ulp
# nudge goes: the state get_default_state returns where the example keeps
# its temperature, else the input of the first call of a stepper in
# NUDGED_INPUT (None: the output depends on the coordinates and the time
# alone, so the spread is 0 and SPREAD_FLOOR sets the limit)
CARD_EXAMPLES = (
    ('radiative_equilibrium', 0, 'get_default_state', dict(n_steps=3)),
    ('radiative_convective_equilibrium', 0, 'get_default_state',
     dict(n_steps=3)),
    ('radiative_equilibrium_rrtmg', 0, 'get_default_state', dict(n_steps=2)),
    ('radiative_equilibrium_rrtmg_realistic_profiles', 0, 'AdamsBashforth',
     dict(n_steps=2)),
    ('simple_physics_example', 0, 'get_default_state', dict(n_steps=3)),
    ('column_code_with_slab', 0, 'AdamsBashforth', dict(n_steps=3)),
    ('gmd_radiative_convective', 0, 'AdamsBashforth', dict(n_steps=3)),
    ('zenith_angle', 0, None, dict(n_steps=2, nx=8, ny=8)),
    ('gmd_aquaplanet', 1, 'get_default_state',
     dict(n_days=0.02, nx=32, ny=16, nz=8, dt_minutes=15)),
    ('grey_gcm_energy_balanced', 2, 'get_default_state',
     dict(n_steps=2, nx=32, ny=16, nz=8)),
)
NUDGED_INPUT = ('AdamsBashforth',)
STORE_SIZE, STORES = (128, 64, 28), 5
GFS_OUTPUTS = ('eastward_wind', 'northward_wind', 'air_temperature',
               'specific_humidity', 'surface_air_pressure', 'air_pressure',
               'air_pressure_on_interface_levels', 'divergence_of_wind',
               'atmosphere_relative_vorticity')
G, AVOGADRO = 9.80665, 6.022140857e23


def phase(n, msg):
    print('[phase %d] %s' % (n, msg), flush=True)


def fail(msg):
    print('chip_smoke FAILED: ' + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps, torch, queued=False):
    """Mean device milliseconds of fn() over reps launches (warmed up).
    queued: the card first sleeps while the host enqueues the reps calls,
    so the events time the kernels back to back and not the host's
    dispatch between them.  Only phase 30 queues: the term writer's call
    (0.16-0.27 ms on the card at a T85 chunk) is as short as its
    launcher's host time, while the other phases keep the timing their
    records have had since they were written."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes, ops, ops_per_s=FP32_OPS_PER_S):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    to move nbytes and do ops operations at ops_per_s."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return max(by_bytes, by_ops), ('bytes' if by_bytes >= by_ops
                                   else 'operations')


def group_cost(layout, ncell):
    """Bytes and operations kernel B needs for one group: every weight,
    every index (4 bytes) of a table of more than one row, the output and
    the packed tables once, weights, outputs and tables in the layout's
    type; one multiply-add per (term, cell, g)."""
    size = layout.table.element_size()
    nbytes = (ncell * sum(size + (4 if rows > 1 else 0)
                          for _, rows in layout.terms)
              + size * ncell * layout.width
              + size * sum(b[6] for b in layout.bands))
    ops = 2 * ncell * sum(b[0] * b[3] for b in layout.bands)
    return nbytes, ops


def kernel_b_groups(groups, tol, card, torch, n=3):
    """Phase ``n`` on one set of kernel-B groups {name: (layout, idx, w)}:
    each against its plain version within tol of max, timed beside its
    bound, the plain version and F.embedding_bag per band.  Returns the
    summed record with one entry per group."""
    from climt_tpu_torch.components.rrtmg import fused_mix

    total = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                 bound_ms=0.0, groups={})
    dtype = None
    for gname, (layout, idx, w) in groups.items():
        dtype = w.dtype
        ncell = idx[0].numel()
        out = fused_mix.mix_groups_cuda(layout, idx, w)
        ref = fused_mix.mix_groups_plain(layout, idx, w)
        lib_fn, lib_check = embedding_bag_call(layout, idx, w, torch)
        torch.cuda.synchronize()
        err, scale = max_rel_err(out, ref)
        lib_err = lib_check(out)
        if not err <= tol * scale:
            fail('kernel B disagrees on %s (%s): max abs err %g > %g * %g'
                 % (gname, dtype, err, tol, scale))
        if not lib_err <= 1e-5 * scale:
            fail('embedding_bag yardstick disagrees on %s by %g'
                 % (gname, lib_err))
        ms = cuda_ms(lambda: fused_mix.mix_groups_cuda(layout, idx, w), 20,
                     torch)
        plain_ms = cuda_ms(
            lambda: fused_mix.mix_groups_plain(layout, idx, w), 3, torch)
        library_ms = cuda_ms(lib_fn, 10, torch)
        nbytes, ops = group_cost(layout, ncell)
        bound_ms, bound_by = bound(
            nbytes, ops, FP64_OPS_PER_S if dtype == torch.float64
            else FP32_OPS_PER_S)
        rec = dict(cells=ncell, terms=layout.nterms, bands=len(layout.bands),
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, mbytes=nbytes / 1e6,
                   share=bound_ms / ms)
        total['groups'][gname] = rec
        for key in ('ms', 'plain_ms', 'library_ms', 'bound_ms'):
            total[key] += rec[key]
        total['max_abs_err'] = max(total['max_abs_err'], err)
        phase(n, 'kernel B %s %s: %d cells, %d bands, %d terms: max abs err '
              '%.3g (max %.3g, limit %g of max); %.4f ms, plain %.4f ms, '
              'embedding_bag %.4f ms, bound %.4f ms (%s, %.1f MB), %.0f%% of '
              'bound' % (gname, str(dtype).replace('torch.', ''), ncell,
                         len(layout.bands), layout.nterms, err, scale, tol,
                         ms, plain_ms, library_ms, bound_ms, bound_by,
                         nbytes / 1e6, 100.0 * bound_ms / ms))
        del out, ref, lib_fn, lib_check
    total['share'] = total['bound_ms'] / total['ms']
    total['bound_by'] = 'bytes'
    phase(n, 'kernel B %s, %d groups (%d launches): %.4f ms, plain %.4f '
          'ms, embedding_bag %.4f ms, bound %.4f ms, %.0f%% of bound; on %s'
          % (str(dtype).replace('torch.', ''), len(groups), len(groups),
             total['ms'],
             total['plain_ms'], total['library_ms'], total['bound_ms'],
             100.0 * total['share'], card))
    return total


def t85_chunk(step_fn, init_fn, dev):
    """The radiation inputs (play, plev, tlay, tlev, tsfc, h2o, o3, co2,
    o2, emis) of the first radiation chunk of the T85 initial state."""
    import torch

    model = step_fn.__self__
    _, _, grids, aux, _ = init_fn(0)
    cols = model._to_cols
    ph_c = cols(grids['p_half'])
    inputs = model.radiation_inputs(
        cols(grids['T']), torch.clamp(cols(grids['q']), min=0.0),
        0.5 * (ph_c[1:] + ph_c[:-1]), ph_c, aux['Ts'].reshape(-1),
        torch.tensor(0.0, device=dev))
    chunk = T85['rad_col_chunk']
    (play, plev, tlay, tlev, tsfc, h2o, o3, co2, o2, _, _, emis) = [
        x[:chunk] if x.dim() == 1 else x[:, :chunk] for x in inputs]
    return play, plev, tlay, tlev, tsfc, h2o, o3, co2, o2, emis


def chunk_lw_coefs(chunk):
    """gas_coefs_lw of a ``t85_chunk``, as the moist GCM calls it: (cs,
    wx)."""
    import torch
    from climt_tpu_torch.components.rrtmg import lw_spectral as LW

    play, plev, tlay, tlev, tsfc, h2o, o3, co2, o2, emis = chunk
    zero = torch.zeros_like(play)
    cs, wx, _ = LW.gas_coefs_lw(play, plev, tlay, tlev, tsfc, emis, h2o, o3,
                                co2, zero, zero, o2, zero, zero, zero, zero,
                                G, AVOGADRO)
    return cs, wx


def chunk_lw_fluxes(chunk):
    """The moist GCM's LW call on a ``t85_chunk`` (kernels B and A):
    rrtmg_lw_fluxes' six outputs."""
    import torch
    from climt_tpu_torch.components.rrtmg import lw_spectral as LW

    play, plev, tlay, tlev, tsfc, h2o, o3, co2, o2, emis = chunk
    zero = torch.zeros_like(play)
    z16 = torch.zeros(play.shape + (16,), dtype=play.dtype,
                      device=play.device)
    return LW.rrtmg_lw_fluxes(
        play, plev, tlay, tlev, tsfc, h2o, o3, co2, zero, zero, o2, zero,
        zero, zero, zero, emis, zero, z16, zero, zero,
        torch.full_like(play, 25.0), torch.full_like(play, 10.0), z16, G,
        AVOGADRO, 1004.64, use_tables=False)


def captured_groups(run, dtype):
    """{name: (layout, idx, w)} of the kernel-B groups in ``dtype`` that
    ``run()`` launches, captured as the components run them."""
    from climt_tpu_torch.components.rrtmg import fused_mix

    captured = {}
    run_group = fused_mix.Group.run

    def capture(group):
        layout, idx, w = group.finish()
        if w.dtype == dtype:
            key = group.key[0]
            captured[key if isinstance(key, str) else key[0]] = (
                layout, idx.clone(), w.clone())
        return run_group(group)

    fused_mix.Group.run = capture
    try:
        run()
    finally:
        fused_mix.Group.run = run_group
    return captured


def example_f64_groups():
    """{name: (layout, idx, w)} of the float64 kernel-B groups of the
    full-radiation example's first call at its own 128x62x28, captured as
    the components run them."""
    import torch

    captured = captured_groups(
        lambda: run_example(FULL_RADIATION, 1, n_steps=1), torch.float64)
    if len(captured) != 6:
        fail('the full-radiation example ran %d float64 kernel-B groups, '
             'not 6: %s' % (len(captured), sorted(captured)))
    return captured


def ptxas_report(log, kernel):
    """{type: (registers, spill store bytes, spill load bytes)} of each
    instantiation (float32 'IfE', float64 'IdE') of ``kernel`` in an nvcc
    -Xptxas -v log."""
    import re

    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m and name and kernel in name:
            dtype = 'float32' if 'IfE' in name else 'float64'
            report[dtype] = [None, int(m.group(1)), int(m.group(2))]
            continue
        m = re.search(r'Used (\d+) registers', line)
        if m and name and kernel in name and report.get(
                'float32' if 'IfE' in name else 'float64'):
            report['float32' if 'IfE' in name else 'float64'][0] = int(
                m.group(1))
            name = None
    return report


def embedding_bag_call(layout, idx, w, torch):
    """One F.embedding_bag per band on pre-clipped, pre-offset, (cells,
    terms) indices and weights: the library yardstick for kernel B, which
    the port never calls.  Returns (fn, check) where check(out) is the
    largest difference from the kernel's output."""
    F = torch.nn.functional
    calls = []
    for ng, ngp, t0, nt, goff, tab0, tablen in layout.bands:
        if nt == 0:
            continue
        term = layout.term_i64[t0:t0 + nt]
        flat = idx[t0:t0 + nt].reshape(nt, -1).long()
        rows = torch.minimum(flat.clamp(min=0), term[:, 1:2] - 1) + (
            (term[:, 0:1] - tab0) // ngp)
        calls.append((rows.T.contiguous(),
                      layout.table[tab0:tab0 + tablen].view(-1, ngp),
                      w[t0:t0 + nt].reshape(nt, -1).T.contiguous(), goff, ng))

    def fn():
        return [F.embedding_bag(i, tab, per_sample_weights=pw, mode='sum')
                for i, tab, pw, _, _ in calls]

    def check(out):
        flat = out.reshape(-1, layout.width)
        return max(float((o[:, :ng] - flat[:, goff:goff + ng]).abs().max())
                   for o, (_, _, _, goff, ng) in zip(fn(), calls))

    return fn, check


def run_example(name, n_calls, device=None, **kw):
    """examples/<name>.py's main() for n_calls dycore calls, from the
    file's own text with ``climt_tpu`` replaced by ``climt_tpu_torch``
    (tests/torch_helpers.py:port_example) and verbose=False: the
    printouts call np.asarray on ``.values``, which on the card are CUDA
    tensors.  The files name no device, so on the card they run as
    written; ``device`` (the CPU, for the comparisons) is given to every
    component they build.  Returns (state, the dycore, seconds of each
    call)."""
    from torch_helpers import EXAMPLE_BIND, port_example

    main, calls = port_example(name, device, EXAMPLE_BIND)
    state = main(verbose=False, **kw)
    if len(calls.seconds) != n_calls:
        fail('%s made %d dycore calls, not %d' % (name, len(calls.seconds),
                                                  n_calls))
    return state, calls.dycores[0] if calls.dycores else None, calls.seconds


def held_suarez_example(n_calls, nx, ny, nz, device=None, dt_minutes=15):
    """examples/held_suarez.py for n_calls calls of dt_minutes."""
    return run_example('held_suarez', n_calls, device,
                       n_days=n_calls * dt_minutes / 1440.0, nx=nx, ny=ny,
                       nz=nz, dt_minutes=dt_minutes)


def wall_s(fn, reps, torch):
    """Mean host seconds of fn() over reps calls, the card synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def held_suarez_model_phase(dev, card, launch_counts, size=T42,
                            steps=T42_STEPS):
    """Phase 8: the fused Held-Suarez model, f32, ``steps`` steps after one
    warm-up step, timed; fails on a non-finite field or T outside
    (150, 350) K."""
    import torch
    from climt_tpu_torch.dycore.compiled import build_held_suarez_model

    dycore, init_fn, step_fn, run_fn = build_held_suarez_model(
        dtype=torch.float32, device=dev, **size)
    carry, _ = step_fn(init_fn(0))              # warm-up step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    carry = run_fn(carry, steps)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sht = dycore.sht
    T = sht.synthesize(carry[1]['T'])
    u, v = sht.uv_from_vort_div(carry[1]['vort'], carry[1]['div'])
    ps = torch.exp(sht.synthesize(carry[1]['lnps']))
    for key, val in (('T', T), ('u', u), ('v', v), ('ps', ps)):
        if not bool(torch.isfinite(val).all()):
            fail('Held-Suarez model: NaN or inf in %s' % key)
    shape = (size['nz'], size['nlat'], size['nlon'])
    if not (tuple(T.shape) == shape
            and 150.0 < float(T.min()) and float(T.max()) < 350.0):
        fail('Held-Suarez model: temperature out of range [%g, %g]' % (
            float(T.min()), float(T.max())))
    points = size['nlon'] * size['nlat'] * size['nz']
    phase(8, 'Held-Suarez %dx%dx%d f32, dt %g s, %d steps: %.6f s/step, '
          '%.6g gridpoint-steps/s; peak memory %.3f GB; T in [%.1f, %.1f] '
          'K, max |u| %.2f m/s; %s; on %s' % (
              size['nlon'], size['nlat'], size['nz'], size['timestep'],
              steps, step_s, points / step_s, peak_gb, float(T.min()),
              float(T.max()), float(u.abs().max()), launch_counts(), card))


def climatology_phase(dev, card, launch_counts, days=30):
    """Phase 9: tests/test_dycore_multistep.py's Held-Suarez climatology
    (64x32x20, dt 1200 s, f64) and its three checks (:35-71)."""
    import numpy as np
    import torch
    from climt_tpu_torch.dycore.compiled import build_held_suarez_model

    dycore, init_fn, _, run_fn = build_held_suarez_model(
        nlon=64, nlat=32, nz=20, timestep=1200.0, dtype=torch.float64,
        device=dev)
    steps = days * 72
    t0 = time.perf_counter()
    carry = run_fn(init_fn(0), steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    sht = dycore.sht
    spec = carry[1]
    T = sht.synthesize(spec['T']).cpu().numpy()
    u, v = (x.cpu().numpy() for x in sht.uv_from_vort_div(spec['vort'],
                                                          spec['div']))
    ps = np.exp(sht.synthesize(spec['lnps']).cpu().numpy())
    if not (np.isfinite(T).all() and np.isfinite(u).all()
            and np.isfinite(v).all() and np.isfinite(ps).all()):
        fail('climatology: non-finite state after %d days' % days)
    if not (150.0 < T.min() and T.max() < 350.0 and np.abs(u).max() < 150.0
            and 8.0e4 < ps.min() and ps.max() < 1.2e5):
        fail('climatology: out of bounds: T [%g, %g], max |u| %g, ps '
             '[%g, %g]' % (T.min(), T.max(), np.abs(u).max(), ps.min(),
                           ps.max()))
    w = sht.weights[:, None]
    mean_ps = (w * ps).sum() / (w.sum() * ps.shape[1])
    if not abs(mean_ps - 1.0e5) < 500.0:
        fail('climatology: global mean ps %g is not within 500 Pa of 1e5'
             % mean_ps)
    uz = u.mean(axis=2)                        # zonal mean, top-down
    lat = np.degrees(np.arcsin(sht.mu))
    mid = (np.abs(lat) > 20.0) & (np.abs(lat) < 70.0)
    upper = uz[:uz.shape[0] // 2, :][:, mid]
    if not (upper.max() > 10.0 and upper.mean() > 0.0):
        fail('climatology: no westerly jet aloft (max %g, mean %g m/s)'
             % (upper.max(), upper.mean()))
    phase(9, 'Held-Suarez 64x32x20 f64, %d days (%d steps of 1200 s) in '
          '%.2f s (%.6f s/step): T in [%.1f, %.1f] K, max |u| %.1f m/s, '
          'global mean ps %.1f Pa, upper midlatitude zonal-mean u max %.1f '
          'mean %.2f m/s; %s; on %s' % (
              days, steps, run_s, run_s / steps, T.min(), T.max(),
              np.abs(u).max(), mean_ps, upper.max(), upper.mean(),
              launch_counts(), card))


def component_api_phase(dev, card, launch_counts, size=(128, 64, 20),
                        n_calls=96):
    """Phase 10: examples/held_suarez.py on the card, ``n_calls`` calls at
    ``size``, timed per call, with the shares of a call spent outside the
    SpectralDycore step and outside the dycore's own transforms; then 8
    calls at 32x16x10 on the CPU and on ``dev``, held against each other
    within EXAMPLE_TOL."""
    import torch

    state, gfs, call_s = held_suarez_example(n_calls, *size)
    for name in GFS_OUTPUTS:
        values = state[name].values
        if not (isinstance(values, torch.Tensor)
                and values.device.type == dev.type):
            fail('component API: %s does not live on %s' % (name, dev))
        if not bool(torch.isfinite(values).all()):
            fail('component API: NaN or inf in %s' % name)
    T = state['air_temperature'].values
    if not (150.0 < float(T.min()) and float(T.max()) < 350.0):
        fail('component API: temperature out of range')
    steady = sorted(call_s[1:])
    call_med = steady[len(steady) // 2]
    # the dycore's share of a call, on its leapfrog memory and the final
    # state: the SpectralDycore step alone, and the step with the analysis
    # of the input fields and the synthesis of the outputs that
    # GFSDynamicalCore.array_call wraps around it
    dyc, prev = gfs._dycore, gfs._prev

    def topdown(name):
        return torch.flip(state[name].transpose(
            'mid_levels', 'lat', 'lon').values, [0])

    fields = [topdown(name) for name in ('eastward_wind', 'northward_wind',
                                         'air_temperature',
                                         'specific_humidity')]
    fields.append(torch.log(state['surface_air_pressure'].values))

    def dynamics():
        _, new, _ = dyc.step(prev, dyc.spectral_state_from_grid(*fields))
        dyc.grid_state_from_spectral(new)
        dyc.sht.synthesize(new['vort'])
        dyc.sht.synthesize(new['div'])

    step_alone = wall_s(lambda: dyc.step(prev, prev), 20, torch)
    dynamics_s = wall_s(dynamics, 20, torch)
    phase(10, 'component API %dx%dx%d f64, examples/held_suarez.py as '
          'written (verbose=False), %d calls of 15 min: first call %.4f s '
          '(builds the SpectralDycore, forward start), then median %.4f '
          's/call [min %.4f, max %.4f]; SpectralDycore.step alone %.4f s '
          '(%.0f%% of a call outside it); with the analysis and synthesis '
          'of the call %.4f s (%.0f%% of a call outside them: marshalling, '
          'HeldSuarez, the physics round trip); max |u| %.2f m/s; %s; on '
          '%s' % (size + (n_calls, call_s[0], call_med, steady[0],
                          steady[-1], step_alone,
                          100.0 * (1.0 - step_alone / call_med), dynamics_s,
                          100.0 * (1.0 - dynamics_s / call_med),
                          float(state['eastward_wind'].values.abs().max()),
                          launch_counts(), card)))
    del state, gfs, dyc, prev, fields
    small = {where: held_suarez_example(8, 32, 16, 10, device=where)[0]
             for where in (torch.device('cpu'), dev)}
    worst = 0.0
    for name in GFS_OUTPUTS:
        err, scale = max_rel_err(small[dev][name].values.cpu(),
                                 small[torch.device('cpu')][name].values)
        if not err <= EXAMPLE_TOL * scale:
            fail('component API: %s on %s differs from the CPU by %g > %g * '
                 '%g' % (name, dev, err, EXAMPLE_TOL, scale))
        worst = max(worst, err / scale if scale else err)
    phase(10, 'component API 32x16x10 f64, 8 calls, %s against the CPU: '
          'largest difference %.3g of max (limit %g)' % (dev, worst,
                                                          EXAMPLE_TOL))


def finite_float_fields(state, torch, label):
    """{name: values} of every floating field of an example's state (or
    a component's outputs), as tensors; fails on a non-finite value."""
    import numpy as np

    out = {}
    for name, value in state.items():
        values = getattr(value, 'values', None)
        if values is None:
            continue
        if not isinstance(values, torch.Tensor):
            values = np.asarray(values)
            if values.dtype.kind != 'f':
                continue
            values = torch.as_tensor(values)
        if not values.is_floating_point():
            continue
        if not bool(torch.isfinite(values).all()):
            fail('%s: NaN or inf in %s' % (label, name))
        out[name] = values
    return out


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def radiation_example_phase(n, name, dev, card, counters, on_call=None):
    """Phases 11 and 13: examples/<name>.py on the card at its own
    128x62x28, float64, dt 600 s, 13 calls; both kernels' launch counts
    are set to 0 just before and read just after.  Fails unless every
    refresh (calls 0, 6, 12) launched kernel B 6 times and kernel A never.
    Returns ({kernel: launches}, the final fields)."""
    import torch

    for counter in counters.values():
        counter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _, call_s = run_example(name, FULL_RADIATION_CALLS,
                                   n_steps=FULL_RADIATION_CALLS)
    launches = {k: c.launches for k, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fields = finite_float_fields(state, torch, name)
    T = fields['air_temperature']
    if not (T.is_cuda and T.dtype == torch.float64
            and tuple(T.shape) == (28, 62, 128)):
        fail('%s: air_temperature is %s %s on %s' % (
            name, T.dtype, tuple(T.shape), T.device))
    if not (150.0 < float(T.min()) and float(T.max()) < 350.0):
        fail('%s: temperature out of range [%g, %g]' % (
            name, float(T.min()), float(T.max())))
    refreshes = [k for k in range(FULL_RADIATION_CALLS) if k % 6 == 0]
    if launches['B'] != 6 * len(refreshes) or launches['A'] != 0:
        fail('%s: kernel launches A=%d B=%d in %d refreshes; RRTMG at '
             'float64 must launch kernel B 6 times a refresh and never '
             'kernel A' % (name, launches['A'], launches['B'],
                           len(refreshes)))
    other = [s for k, s in enumerate(call_s) if k not in refreshes]
    phase(n, '%s 128x62x28 f64, dt 600 s, %d calls: refresh calls %s s '
          '(median %.4f), other calls median %.4f s [min %.4f, max %.4f]; '
          'peak memory %.2f GB; per refresh kernel B %g, kernel A %g '
          'launches; T in [%.1f, %.1f] K, max |u| %.2f m/s; on %s' % (
              name, FULL_RADIATION_CALLS,
              ' '.join('%.4f' % call_s[k] for k in refreshes),
              median([call_s[k] for k in refreshes]), median(other),
              min(other), max(other), peak_gb,
              launches['B'] / len(refreshes), launches['A'] / len(refreshes),
              float(T.min()), float(T.max()),
              float(fields['eastward_wind'].abs().max()), card))
    return launches, fields


def nudge_temperature(out):
    """``out`` (a state or a component's diagnostics) with its air
    temperature raised by one ulp in place."""
    import numpy as np
    import torch

    T = out['air_temperature'].values
    if isinstance(T, torch.Tensor):
        T.copy_(torch.nextafter(T, torch.full_like(T, float('inf'))))
    else:
        T[:] = np.nextafter(T, np.inf)
    return out


def nudged(made):
    """A stand-in for a function or a component class of climt_tpu_torch
    whose result has its air temperature one ulp higher."""
    if isinstance(made, type):
        return type(made.__name__, (made,), {
            '__call__': lambda self, *args: nudge_temperature(
                made.__call__(self, *args))})
    return lambda *args, **kwargs: nudge_temperature(made(*args, **kwargs))


def nudged_input(cls):
    """A stand-in for a stepper class of climt_tpu_torch whose instances
    raise the air temperature of the state they are first called with by
    one ulp, in place: after the example has set its state up."""
    def call(self, state, *args):
        if not getattr(self, '_nudged', False):
            self._nudged = True
            nudge_temperature(state)
        return cls.__call__(self, state, *args)

    return type(cls.__name__, (cls,), {'__call__': call})


def largest_difference(a, b):
    """The largest max |a - b| / max |b| over the fields of b."""
    worst = 0.0
    for name, ref in b.items():
        err, scale = max_rel_err(a[name].cpu(), ref.cpu())
        worst = max(worst, err / scale if scale else err)
    return worst


def card_vs_cpu(name, n_calls, dev, card_fields=None,
                nudge_at='get_default_state', floor=0.0, **kw):
    """examples/<name>.py (n_calls dycore calls) on the card against the
    CPU: (worst, limit, spread), where worst is the card's largest
    difference from the CPU and limit 10 times the larger of ``floor``
    and the spread, the largest difference that one ulp more initial
    temperature (set in what climt_tpu_torch.<nudge_at> returns, or in the
    first input of a stepper of NUDGED_INPUT; no nudge and a spread of 0
    with nudge_at None) makes in the same CPU run.  Fails above the limit.
    ``card_fields`` is a card run's final fields, where the caller has
    one."""
    import torch

    import climt_tpu_torch

    def fields(device):
        return finite_float_fields(run_example(
            name, n_calls, device, **kw)[0], torch, name)

    def nudged_fields(device):
        made = getattr(climt_tpu_torch, nudge_at)
        setattr(climt_tpu_torch, nudge_at, (
            nudged_input if nudge_at in NUDGED_INPUT else nudged)(made))
        try:
            return fields(device)
        finally:
            setattr(climt_tpu_torch, nudge_at, made)

    cpu = torch.device('cpu')
    host = fields(cpu)
    spread = (0.0 if nudge_at is None
              else largest_difference(nudged_fields(cpu), host))
    limit = 10.0 * max(spread, floor)
    worst = largest_difference(
        fields(dev) if card_fields is None else card_fields, host)
    if not worst <= limit:
        fail('%s: the card differs from the CPU by %.3g of max, more than '
             '%.3g (10 x the one-ulp spread %.3g)' % (name, worst, limit,
                                                      spread))
    return worst, limit, spread


def full_radiation_card_vs_cpu_phase(dev, card, launch_counts):
    """Phase 12: the example at 16x8x8 for 7 calls on the card against the
    CPU, within 10 times the largest relative change (max |a - b| / max
    |b| over the fields) that raising the initial temperature by one ulp
    makes in the same CPU run."""
    worst, limit, spread = card_vs_cpu(FULL_RADIATION, 7, dev, n_steps=7,
                                       nx=16, ny=8, nz=8)
    phase(12, '%s 16x8x8 f64, 7 calls, %s against the CPU: largest '
          'difference %.3g of max; limit %.3g = 10 x %.3g, the largest '
          'change that one ulp more initial temperature makes on the CPU; '
          '%s; on %s' % (FULL_RADIATION, dev, worst, limit, spread,
                         launch_counts(), card))


def insolation_phase(dev, card, counters):
    """Phase 13: examples/full_radiation_with_insolation_gcm.py on the card
    at its own size (phase 11's checks), with each Instellation call timed
    and its zenith angle kept, which must change between calls; then at
    16x8x8 for 7 calls on the card against the CPU.  Returns {kernel:
    launches} of the full-size run."""
    import torch

    from climt_tpu_torch.components.instellation import Instellation

    seconds, zenith = [], []
    call = Instellation.__call__

    def timed_call(self, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(self, state)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        zenith.append(out['zenith_angle'].values.clone())
        return out

    Instellation.__call__ = timed_call
    try:
        launches, _ = radiation_example_phase(13, INSOLATION, dev, card,
                                              counters)
    finally:
        del Instellation.__call__
    if len(zenith) != FULL_RADIATION_CALLS or not zenith[0].is_cuda:
        fail('%s: %d Instellation calls on %s' % (
            INSOLATION, len(zenith), zenith[0].device if zenith else None))
    moved = max(float((z - zenith[0]).abs().max()) for z in zenith[1:])
    if not moved > 1e-3:
        fail('%s: the zenith angle moved by %g rad in %d calls' % (
            INSOLATION, moved, len(zenith)))
    phase(13, '%s: Instellation call median %.6f s [min %.6f, first %.6f]; '
          'zenith angle moved up to %.4f rad from the first call; on %s' % (
              INSOLATION, median(seconds[1:]), min(seconds[1:]), seconds[0],
              moved, card))
    worst, limit, spread = card_vs_cpu(INSOLATION, 7, dev, n_steps=7, nx=16,
                                       ny=8, nz=8)
    phase(13, '%s 16x8x8 f64, 7 calls, %s against the CPU: largest '
          'difference %.3g of max; limit %.3g = 10 x the one-ulp spread '
          '%.3g; on %s' % (INSOLATION, dev, worst, limit, spread, card))
    return launches


def examples_phase(dev, card):
    """Phase 14: examples/baroclinic_wave.py at 128x64x20 (100 calls) and
    examples/grey_radiative_convective.py at nz=30 (100 steps) on the card,
    timed, finite, T in (150, 350) K, and held against the CPU.  The DCMIP
    initial state replaces the default state's temperature, so the
    baroclinic wave's one-ulp nudge goes into DcmipInitialConditions'
    output."""
    import torch

    state, _, call_s = run_example(BAROCLINIC, EXAMPLE_CALLS,
                                   n_steps=EXAMPLE_CALLS)
    fields = finite_float_fields(state, torch, BAROCLINIC)
    T, u = fields['air_temperature'], fields['eastward_wind']
    if not (T.is_cuda and tuple(T.shape) == (20, 64, 128)
            and 150.0 < float(T.min()) and float(T.max()) < 350.0):
        fail('%s: air_temperature %s on %s in [%g, %g]' % (
            BAROCLINIC, tuple(T.shape), T.device, float(T.min()),
            float(T.max())))
    ps = fields['surface_air_pressure']
    worst, limit, spread = card_vs_cpu(
        BAROCLINIC, EXAMPLE_CALLS, dev, card_fields=fields,
        nudge_at='DcmipInitialConditions', n_steps=EXAMPLE_CALLS)
    phase(14, '%s 128x64x20 f64, %d calls of 10 min: first call %.4f s, '
          'then median %.4f s/call [min %.4f, max %.4f]; ps in [%.1f, %.1f] '
          'Pa, max |u| %.2f m/s; against the CPU: largest difference %.3g '
          'of max, limit %.3g = 10 x the one-ulp spread %.3g; on %s' % (
              BAROCLINIC, EXAMPLE_CALLS, call_s[0], median(call_s[1:]),
              min(call_s[1:]), max(call_s[1:]), float(ps.min()),
              float(ps.max()), float(u.abs().max()), worst, limit, spread,
              card))
    del state, fields, T, u, ps

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _, _ = run_example(GREY, 0, n_steps=EXAMPLE_CALLS)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / EXAMPLE_CALLS
    fields = finite_float_fields(state, torch, GREY)
    T = fields['air_temperature']
    if not (T.is_cuda and T.numel() == 30
            and 150.0 < float(T.min()) and float(T.max()) < 350.0):
        fail('%s: air_temperature %s on %s in [%g, %g]' % (
            GREY, tuple(T.shape), T.device, float(T.min()), float(T.max())))
    worst, limit, spread = card_vs_cpu(GREY, 0, dev, card_fields=fields,
                                       n_steps=EXAMPLE_CALLS)
    phase(14, '%s nz=30 f64, %d steps of 2 h: %.5f s/step (the state '
          'built on the host included); T in [%.1f, %.1f] K, surface %.2f '
          'K; against the CPU: largest difference %.3g of max, limit %.3g '
          '= 10 x the one-ulp spread %.3g; on %s' % (
              GREY, EXAMPLE_CALLS, step_s, float(T.min()), float(T.max()),
              float(fields['surface_temperature'].reshape(-1)[0]), worst,
              limit, spread, card))


def land_surface_stack(device, nudge=False, size=LAND_SIZE,
                       n_calls=LAND_CALLS):
    """The land-surface components on one nx x ny x nz float64 state on
    ``device``, each called n_calls times on its own copy of the state
    (a stepper's outputs fed back).  area_type comes from LandMask, with
    the sea poleward of 70 degrees made sea ice; the other fields from
    tests/torch_helpers.py:ice_fields and a seed.  With ``nudge`` every
    nonzero floating field but latitude and longitude starts one ulp
    higher: the coordinates pick area types and nearest neighbours, and a
    zero snow depth made 5e-324 would take the snow albedo.  Returns
    ({component: its last call's outputs}, {component: seconds of each
    call})."""
    import numpy as np
    import torch

    import climt_tpu_torch as ct
    from torch_helpers import ice_fields

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize()

    comps = {
        'LandMask': ct.LandMask(device=device),
        'DataOcean': ct.DataOcean(device=device),
        'DataOcean(compute_fluxes)': ct.DataOcean(device=device,
                                                  compute_fluxes=True),
        'SecondBEST': ct.SecondBEST(device=device),
        'BucketHydrology': ct.BucketHydrology(device=device),
        'BucketHydrology(num_layers=2)': ct.BucketHydrology(
            device=device, num_layers=2),
        'SeaIce': ct.SeaIce(device=device),
        'LandIce': ct.LandIce(device=device),
        'SimpleBoundaryLayer': ct.SimpleBoundaryLayer(device=device),
        'BergerSolarInsolation': ct.BergerSolarInsolation(device=device),
    }
    nx, ny, nz = size
    base = ct.get_default_state(
        [c for label, c in comps.items()
         if label != 'DataOcean(compute_fluxes)'],
        grid_state=ct.get_grid(nx=nx, ny=ny, nz=nz))
    rng = np.random.RandomState(0)
    fields = ice_fields(base, rng)
    shape = fields['surface_temperature'].shape
    soil = base['soil_temperature'].shape
    fields.update({
        'lwe_thickness_of_soil_moisture_content': 0.2 * rng.rand(*shape),
        'deep_soil_moisture_content': 0.55 * rng.rand(*shape),
        'deep_soil_temperature': 280.0 + 10.0 * rng.rand(*shape),
        'convective_precipitation_rate': 20.0 * rng.rand(*shape),
        'stratiform_precipitation_rate': 1e-7 * rng.rand(*shape),
        'soil_temperature': 278.0 + 10.0 * rng.rand(*soil),
        'soil_liquid_water_content': 0.05 + 0.3 * rng.rand(*soil),
    })
    for name, value in fields.items():
        if name != 'area_type':
            base[name].values[:] = value
    if nudge:
        for name, value in base.items():
            values = getattr(value, 'values', None)
            if (isinstance(values, np.ndarray) and values.dtype.kind == 'f'
                    and name not in ('latitude', 'longitude')):
                values[:] = np.where(values == 0.0, 0.0,
                                     np.nextafter(values, np.inf))
    # DataOcean(compute_fluxes) reads the near-surface fields as (lat,
    # lon) fields
    flux_state = dict(base)
    for name in ('eastward_wind', 'northward_wind', 'air_temperature',
                 'specific_humidity'):
        flux_state[name] = ct.DataArray(
            base[name].values[0].copy(), dims=base[name].dims[1:],
            attrs={'units': base[name].attrs['units']})
    flux_state['air_density'] = ct.DataArray(
        base['air_pressure'].values[0]
        / (287.04 * base['air_temperature'].values[0]),
        dims=base['air_pressure'].dims[1:], attrs={'units': 'kg/m^3'})

    dt = datetime.timedelta(minutes=30)
    outputs, seconds = {}, {}

    def run(label, state):
        comp, state, secs = comps[label], dict(state), []
        for _ in range(n_calls):
            sync()
            t0 = time.perf_counter()
            if isinstance(comp, ct.DiagnosticComponent):
                out = comp(state)
            else:
                diagnostics, new_state = comp(state, dt)
                state.update(new_state)
                out = dict(diagnostics, **new_state)
            sync()
            secs.append(time.perf_counter() - t0)
        outputs[label], seconds[label] = out, secs
        return out

    area = np.array(run('LandMask', base)['area_type'].transpose(
        *base['area_type'].dims).values)
    lat = np.asarray(base['latitude'].transpose(
        *base['area_type'].dims).values)
    area[(np.abs(lat) > 70.0) & (area == 'sea')] = 'sea_ice'
    base['area_type'].values[:] = area           # flux_state's too
    for label in comps:
        if label != 'LandMask':
            run(label, flux_state if label == 'DataOcean(compute_fluxes)'
                else base)
    return outputs, seconds


def land_surface_phase(dev, card):
    """Phase 15: the land-surface stack at 128x64x28 float64 on the card
    (ms per call after the first) and twice on the CPU, the second with
    every input one ulp higher: each component's last outputs on the card
    within 10 times the larger of that spread and SPREAD_FLOOR of
    the CPU's, its string and scalar outputs equal."""
    import numpy as np
    import torch

    card_out, card_s = land_surface_stack(dev)
    cpu = torch.device('cpu')
    host, _ = land_surface_stack(cpu)
    moved, _ = land_surface_stack(cpu, nudge=True)
    area = np.asarray(host['LandMask']['area_type'].values)
    kinds = {k: int((area == k).sum()) for k in ('sea', 'land', 'land_ice')}
    phase(15, 'land-surface stack %dx%dx%d f64, %d calls each, area types '
          'from LandMask: %s, sea ice poleward of 70 degrees' % (
              LAND_SIZE + (LAND_CALLS, kinds)))
    for label, ref in host.items():
        floats = finite_float_fields(ref, torch, label)
        on_card = finite_float_fields(card_out[label], torch, label)
        for name, value in ref.items():
            if name not in floats and not np.array_equal(
                    np.asarray(value.values),
                    np.asarray(card_out[label][name].values)):
                fail('%s: %s differs between the card and the CPU' % (
                    label, name))
        if not all(v.is_cuda for v in on_card.values()
                   if v.dim() > 0):
            fail('%s: an output does not live on the card' % label)
        spread = largest_difference(
            finite_float_fields(moved[label], torch, label), floats)
        limit = 10.0 * max(spread, SPREAD_FLOOR)
        worst = largest_difference(on_card, floats)
        if not worst <= limit:
            fail('%s: the card differs from the CPU by %.3g of max, more '
                 'than %.3g (10 x the one-ulp spread %.3g, floor %.3g)' % (
                     label, worst, limit, spread, SPREAD_FLOOR))
        secs = card_s[label]
        phase(15, '%s: %.3f ms/call [min %.3f, max %.3f; first %.3f]; '
              'against the CPU %.3g of max, limit %.3g (one-ulp spread '
              '%.3g); on %s' % (label, 1e3 * median(secs[1:]),
                                1e3 * min(secs[1:]), 1e3 * max(secs[1:]),
                                1e3 * secs[0], worst, limit, spread, card))


def cuda_median_ms(fn, reps, torch):
    """Median device milliseconds of fn() over reps calls, each between
    its own pair of CUDA events (warmed up)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return median(times)


def device_launches(fn, torch):
    """The device operations (kernels and copies) one call of fn()
    launches, counted by torch.profiler; fails when the profiler sees
    none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    if n == 0:
        fail('torch.profiler saw no device operation')
    return n


def nudge_all(fields, torch):
    """Copies of the tensors ``fields`` with every nonzero value one ulp
    higher."""
    return [torch.where(x == 0.0, x, torch.nextafter(
        x, torch.full_like(x, float('inf')))) for x in fields]


def transport_inputs(dev):
    """(dycore, [q, dp, u, v, mdot]): the T85 moist GCM with FV moisture
    in float32 after its first step, the moisture of that state and the
    winds, layer thicknesses and interface mass fluxes its
    diagnose_mass_fluxes gives."""
    import torch
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm

    dycore, init_fn, step_fn, _ = build_moist_gcm(
        dtype=torch.float32, device=dev, moisture_advection='fv', **T85)
    carry, _ = step_fn(init_fn(0), None)
    u, v, dp, mdot = dycore.diagnose_mass_fluxes(carry[1])
    return dycore, [carry[1]['q'], dp, u, v, mdot]


def transport_phase(dev, card):
    """Phase 16: FVAdvection and SLAdvection on the T85 grid in float32
    and float64, on one state of the FV moist GCM: ms per advect call
    (median of TRANSPORT_REPS), device launches per call, FV's zonal bands
    and band-substeps (T85_ZONAL); float64 on the card within 10 x the
    larger of SPREAD_FLOOR and the one-ulp spread of the CPU; a uniform
    field kept within UNIFORM_TOL and FV's tracer mass within MASS_TOL on
    the card."""
    import torch
    from climt_tpu_torch.ops.fv_advection import FVAdvection
    from climt_tpu_torch.ops.sl_advection import SLAdvection

    dycore, fields32 = transport_inputs(dev)
    sht, cpu = dycore.sht, torch.device('cpu')
    dt = TRANSPORT_DT
    for kind, cls in zip(GRID_MODES, (FVAdvection, SLAdvection)):
        for dtype in (torch.float32, torch.float64):
            tname = str(dtype).replace('torch.', '')
            fields = [x.to(dtype) for x in fields32]
            q, dp, u, v, mdot = fields

            def make(device):
                return cls(sht.mu, sht.weights, sht.nlon, sht.radius, dt,
                           dtype=dtype, device=device)

            op = make(dev)
            out = op.advect(q, dp, u, v, mdot, dt)
            if not (out.shape == q.shape and out.dtype == dtype
                    and bool(torch.isfinite(out).all())):
                fail('%s %s: advect gave %s, finite %s' % (
                    kind, tname, tuple(out.shape),
                    bool(torch.isfinite(out).all())))
            ms = cuda_median_ms(lambda: op.advect(q, dp, u, v, mdot, dt),
                                TRANSPORT_REPS, torch)
            launches = device_launches(
                lambda: op.advect(q, dp, u, v, mdot, dt), torch)
            msg = '%s %s %dx%dx%d, dt %g s: %.3f ms per advect call ' \
                  '(median of %d), %d device launches per call' % (
                      (cls.__name__, tname) + tuple(q.shape[::-1])
                      + (dt, ms, TRANSPORT_REPS, launches))
            if kind == 'fv':
                bands = (len(op.zonal_bands),
                         sum(n for _, _, n in op.zonal_bands))
                if bands != T85_ZONAL:
                    fail('FV at T85: %d zonal bands and %d band-substeps, '
                         'not %d and %d' % (bands + T85_ZONAL))
                msg += ('; %d zonal bands, %d band-substeps in %d loops of '
                        'substep counts %s' % (
                            bands + (len(op.zonal_counts),
                                     op.zonal_counts)))
            uniform = op.advect(torch.ones_like(q), dp, u, v, mdot, dt)
            kept = float((uniform - 1.0).abs().max())
            if not kept <= UNIFORM_TOL[tname]:
                fail('%s %s: a uniform field moved by %g > %g' % (
                    kind, tname, kept, UNIFORM_TOL[tname]))
            msg += '; uniform field kept to %.3g (limit %g)' % (
                kept, UNIFORM_TOL[tname])
            if kind == 'fv':
                m0 = float(op.total_mass(q, dp))
                q1, dp1 = op._zonal(q, dp, u, dt)
                q1, dp1 = op._meridional(q1, dp1, v, dt)
                q1, dp1 = op._vertical(q1, dp1, mdot, dt)
                mass = abs(float(op.total_mass(q1, dp1)) - m0) / abs(m0)
                if not mass <= MASS_TOL[tname]:
                    fail('FV %s: tracer mass changed by %g of itself > %g'
                         % (tname, mass, MASS_TOL[tname]))
                msg += '; tracer mass conserved to %.3g (limit %g)' % (
                    mass, MASS_TOL[tname])
            if dtype == torch.float64:
                host_op = make(cpu)
                host_in = [x.cpu() for x in fields]
                host = host_op.advect(*host_in, dt)
                spread = largest_difference(
                    {'q': host_op.advect(*nudge_all(host_in, torch), dt)},
                    {'q': host})
                limit = 10.0 * max(spread, SPREAD_FLOOR)
                worst = largest_difference({'q': out}, {'q': host})
                if not worst <= limit:
                    fail('%s float64: the card differs from the CPU by %.3g '
                         'of max, more than %.3g (10 x the one-ulp spread '
                         '%.3g, floor %.3g)' % (kind, worst, limit, spread,
                                                SPREAD_FLOOR))
                msg += ('; against the CPU %.3g of max, limit %.3g '
                        '(one-ulp spread %.3g)' % (worst, limit, spread))
            phase(16, msg + '; on ' + card)
            del op, out, uniform, fields
    del dycore, fields32
    torch.cuda.empty_cache()


def grid_moisture_phase(dev, card, counters):
    """Phase 17: the moist GCM with FV and with SL moisture at T85, f32,
    T85_STEPS steps each through build_moist_gcm, both kernels' launch
    counts set to 0 before each run and read after it: fails on a
    non-finite field, T outside (150, 350) K, or other than 24 kernel-B and
    4 kernel-A launches per refresh.  Then both at GRID_SMALL for 7 steps
    on the card against the CPU within SMALL_TOL.  Returns {kernel:
    launches} summed over the two T85 runs."""
    import numpy as np
    import torch
    from climt_tpu_torch.convert import carry_to_numpy
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm

    total = {k: 0 for k in counters}
    refreshes = sum(1 for k in range(T85_STEPS) if k % T85['rad_every'] == 0)
    for mode in GRID_MODES:
        dycore, init_fn, step_fn, _ = build_moist_gcm(
            dtype=torch.float32, device=dev, moisture_advection=mode, **T85)
        carry = init_fn(0)
        torch.cuda.synchronize()
        for counter in counters.values():
            counter.launches = 0
        step_s, diag = [], None
        for _ in range(T85_STEPS):
            t0 = time.perf_counter()
            carry, diag = step_fn(carry, None)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = {k: c.launches for k, c in counters.items()}
        T = dycore.sht.synthesize(carry[1]['T'])
        q = carry[1]['q']
        for key, val in [('T', T), ('q', q)] + list(diag.items()):
            if not bool(torch.isfinite(val).all()):
                fail('T85 %s: NaN or inf in %s' % (mode, key))
        shape = (T85['nz'], T85['nlat'], T85['nlon'])
        if not (tuple(T.shape) == tuple(q.shape) == shape
                and not q.is_complex()
                and 150.0 < float(T.min()) and float(T.max()) < 350.0):
            fail('T85 %s: T %s in [%g, %g], q %s %s' % (
                mode, tuple(T.shape), float(T.min()), float(T.max()),
                tuple(q.shape), q.dtype))
        if launches != {'B': 24 * refreshes, 'A': 4 * refreshes}:
            fail('T85 %s: kernel launches A=%d B=%d in %d refreshes, not 4 '
                 'and 24 each' % (mode, launches['A'], launches['B'],
                                  refreshes))
        for k in total:
            total[k] += launches[k]
        mean_s = sum(step_s) / len(step_s)
        rad = [s for i, s in enumerate(step_s) if i % T85['rad_every'] == 0]
        other = [s for i, s in enumerate(step_s)
                 if i % T85['rad_every'] != 0]
        phase(17, 'T85 moisture_advection=%r f32, %d steps: %.4f s/step, '
              '%.4g gridpoint-steps/s; radiation steps %s s, others median '
              '%.4f s [min %.4f, max %.4f]; per refresh kernel B %g, kernel '
              'A %g launches; T in [%.1f, %.1f] K, q in [%.3g, %.3g]; on %s'
              % (mode, T85_STEPS, mean_s, 256 * 128 * 28 / mean_s,
                 ' '.join('%.4f' % s for s in rad), median(other),
                 min(other), max(other), launches['B'] / refreshes,
                 launches['A'] / refreshes, float(T.min()), float(T.max()),
                 float(q.min()), float(q.max()), card))
        del dycore, init_fn, step_fn, carry, diag, T, q
        torch.cuda.empty_cache()

    for mode in GRID_MODES:
        finals = {}
        for label, where in (('cpu', torch.device('cpu')), ('card', dev)):
            _, init_fn, _, run_fn = build_moist_gcm(
                device=where, dtype=torch.float32, moisture_advection=mode,
                **GRID_SMALL)
            finals[label] = carry_to_numpy(run_fn(init_fn(0), 7)[0])[2]
        diffs = {}
        for key, tol in SMALL_TOL.items():
            a, b = finals['card'][key], finals['cpu'][key]
            if not np.isfinite(a).all():
                fail('phase 17 %s: non-finite %s on the card' % (mode, key))
            diffs[key] = float(np.abs(a - b).max())
            if not diffs[key] <= tol:
                fail('phase 17 %s: %s differs by %g > %g' % (
                    mode, key, diffs[key], tol))
        phase(17, '%dx%dx%d f32 moisture_advection=%r, 7 steps, card '
              'against the CPU, max abs diff: %s (limits %s)' % (
                  GRID_SMALL['nlon'], GRID_SMALL['nlat'], GRID_SMALL['nz'],
                  mode, ', '.join('%s %.3g' % kv for kv in diffs.items()),
                  ', '.join('%s %g' % kv for kv in SMALL_TOL.items())))
    return total


def gfs_tracer_run(device, size, n_calls, nudge=False):
    """GFSDynamicalCore(moisture_advection='fv') with the two TRACERS
    registered, on a state of nx x ny x nz from get_default_state with a
    12 m/s zonal wind and 0.1 K of seeded noise on the temperature (one
    ulp more with ``nudge``), a Gaussian blob and a uniform field as the
    tracers; n_calls calls of 10 minutes.  Returns (final state, seconds
    of each call)."""
    import numpy as np
    import torch

    import climt_tpu_torch as ct

    ct.reset_tracers()
    ct.reset_packers()
    for name in TRACERS:
        ct.register_tracer(name, 'kg/kg')
    try:
        nx, ny, nz = size
        dycore = ct.GFSDynamicalCore(device=device, moisture_advection='fv')
        state = ct.get_default_state(
            [dycore], grid_state=ct.get_grid(nx=nx, ny=ny, nz=nz))
        shape = state['air_temperature'].shape
        rng = np.random.RandomState(0)
        state['eastward_wind'].values[:] = 12.0
        state['air_temperature'].values[:] += 0.1 * rng.randn(*shape)
        if nudge:
            nudge_temperature(state)
        lon = np.asarray(state['longitude'].values)
        lat = np.asarray(state['latitude'].values)
        blob = np.exp(-((lon - 180.0) ** 2 + (lat - 30.0) ** 2) / 400.0)
        dims = state['air_temperature'].dims
        for name, field in zip(TRACERS, (
                np.broadcast_to(blob, shape),
                np.full(shape, UNIFORM_TRACER))):
            state[name] = ct.DataArray(np.array(field), dims=dims,
                                       attrs={'units': 'kg/kg'})
        seconds = []
        for _ in range(n_calls):
            t0 = time.perf_counter()
            _, new_state = dycore(state, datetime.timedelta(minutes=10))
            state.update(new_state)
            if device.type == 'cuda':
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        return state, seconds
    finally:
        ct.reset_tracers()
        ct.reset_packers()


def tracer_phase(dev, card):
    """Phase 18: GFSDynamicalCore with FV moisture and two registered
    tracers at TRACER_SIZE, float64, TRACER_CALLS calls on the card: s per
    call, finite tracers on the card, the uniform one within 1e-10 of its
    value; then at 32x16x10 for 8 calls on the card against the CPU,
    within 10 x the larger of SPREAD_FLOOR and the one-ulp spread."""
    import torch

    state, seconds = gfs_tracer_run(dev, TRACER_SIZE, TRACER_CALLS)
    fields = finite_float_fields(state, torch, 'tracers')
    for name in TRACERS + ('specific_humidity', 'air_temperature'):
        if not fields[name].is_cuda:
            fail('tracers: %s does not live on the card' % name)
    kept = float((fields['tracer_uniform'] - UNIFORM_TRACER).abs().max())
    if not kept <= 1e-10 * UNIFORM_TRACER:
        fail('tracers: the uniform tracer moved by %g' % kept)
    blob = fields['tracer_blob']
    phase(18, 'GFSDynamicalCore fv + %d tracers %dx%dx%d f64, %d calls of 10 '
          'min: first call %.4f s, then median %.4f s/call [min %.4f, max '
          '%.4f]; uniform tracer kept to %.3g; blob in [%.3g, %.3g]; on %s'
          % ((len(TRACERS),) + TRACER_SIZE + (
              TRACER_CALLS, seconds[0], median(seconds[1:]),
              min(seconds[1:]), max(seconds[1:]), kept, float(blob.min()),
              float(blob.max()), card)))
    del state, fields, blob
    cpu = torch.device('cpu')
    small = (32, 16, 10)

    def run(device, nudge=False):
        return finite_float_fields(gfs_tracer_run(device, small, 8, nudge)[0],
                                   torch, 'tracers')

    host = run(cpu)
    spread = largest_difference(run(cpu, nudge=True), host)
    limit = 10.0 * max(spread, SPREAD_FLOOR)
    worst = largest_difference(run(dev), host)
    if not worst <= limit:
        fail('tracers: the card differs from the CPU by %.3g of max, more '
             'than %.3g (10 x the one-ulp spread %.3g)' % (worst, limit,
                                                            spread))
    phase(18, 'GFSDynamicalCore fv + tracers 32x16x10 f64, 8 calls, card '
          'against the CPU: largest difference %.3g of max, limit %.3g (one-'
          'ulp spread %.3g); on %s' % (worst, limit, spread, card))


def examples_io_phase(dev, card, counters):
    """Phase 19: the CARD_EXAMPLES on the card against the CPU, each
    within 10 x the larger of SPREAD_FLOOR and its one-ulp spread, both
    kernels' launch counts set to 0 before and read after; then a
    STORE_SIZE float64 state on the card stored STORES times through
    NetCDFMonitor (backend='native', write_on_store=True) and once through
    RestartMonitor, ms per store, the file read back with scipy and the
    restart's load() equal to the card's fields.  Returns {kernel:
    launches} of the examples."""
    import tempfile

    import numpy as np
    import torch
    from scipy.io import netcdf_file

    import climt_tpu_torch as ct
    from climt_tpu_torch.core.dataarray import to_numpy

    for counter in counters.values():
        counter.launches = 0
    for name, n_calls, nudge_at, kw in CARD_EXAMPLES:
        t0 = time.perf_counter()
        worst, limit, spread = card_vs_cpu(name, n_calls, dev,
                                           nudge_at=nudge_at,
                                           floor=SPREAD_FLOOR, **kw)
        phase(19, '%s %s, three runs (CPU, CPU one ulp nudged at %s, card) '
              'in %.1f s: the card %.3g of max from the CPU, limit %.3g '
              '(one-ulp spread %.3g); on %s' % (
                  name, ' '.join('%s=%s' % kv for kv in kw.items()),
                  nudge_at, time.perf_counter() - t0, worst, limit, spread,
                  card))
    launches = {k: c.launches for k, c in counters.items()}

    nx, ny, nz = STORE_SIZE
    dycore = ct.GFSDynamicalCore(device=dev)
    state = ct.get_default_state([dycore], grid_state=ct.get_grid(
        nx=nx, ny=ny, nz=nz))
    _, new_state = dycore(state, datetime.timedelta(minutes=10))
    state.update(new_state)
    for name, value in list(state.items()):
        values = getattr(value, 'values', None)
        if isinstance(values, np.ndarray) and values.dtype.kind == 'f':
            state[name] = ct.DataArray(
                torch.as_tensor(values, device=dev), dims=value.dims,
                attrs=value.attrs)
    on_card = {name: value for name, value in state.items()
               if isinstance(getattr(value, 'values', None), torch.Tensor)}
    if not (on_card and all(v.values.is_cuda for v in on_card.values())):
        fail('IO: the state does not live on the card')
    expected = {name: to_numpy(v.values) for name, v in on_card.items()}
    mbytes = sum(a.nbytes for a in expected.values()) / 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'state.nc')
        monitor = ct.NetCDFMonitor(path, write_on_store=True,
                                   backend='native')
        store_s = []
        for k in range(STORES):
            state['time'] = state['time'] + datetime.timedelta(minutes=10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            monitor.store(state)
            store_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        monitor.close()
        close_s = time.perf_counter() - t0
        f = netcdf_file(path, 'r', mmap=False)
        try:
            if f.variables['time'].data.shape != (STORES,):
                fail('IO: the file holds %s records, not %d' % (
                    f.variables['time'].data.shape, STORES))
            for name, ref in expected.items():
                data = f.variables[name].data
                if not all(np.array_equal(data[k], ref)
                           for k in range(STORES)):
                    fail('IO: %s read back differs from the card' % name)
        finally:
            f.close()
        restart = ct.RestartMonitor(os.path.join(tmp, 'restart'))
        t0 = time.perf_counter()
        restart.store(state)
        restart_s = time.perf_counter() - t0
        loaded = restart.load()
        for name, ref in expected.items():
            if not np.array_equal(np.asarray(loaded[name].values), ref):
                fail('IO: %s of the restart differs from the card' % name)
        if loaded['time'] != state['time']:
            fail('IO: the restart time differs')
    phase(19, 'NetCDFMonitor native, write_on_store, %dx%dx%d f64 state on '
          'the card, %d fields (%.1f MB a store): %s ms per store (median '
          '%.2f), close %.2f ms; RestartMonitor %.2f ms per store; the file '
          'and the restart equal the card exactly; on %s' % (
              nx, ny, nz, len(expected), mbytes,
              ' '.join('%.2f' % (1e3 * s) for s in store_s),
              1e3 * median(store_s), 1e3 * close_s, 1e3 * restart_s, card))
    return launches


def timed_steps(step_fn, carry, n, torch):
    """(carry, diagnostics, seconds of each step) of n synchronised steps."""
    step_s, diag = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        carry, diag = step_fn(carry, None)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    return carry, diag, step_s


def mesh_world_of_one_phase(dev, card, counters, phase6_s):
    """Phase 20 (a): one NCCL rank in this process (its rendezvous a
    FileStore in a temporary directory), the T85 moist GCM built with
    build_moist_gcm(mesh=make_mesh(1)) with spectral and with FV moisture,
    float32.  For each mode: one step from seed 0 against the
    single-device model within MESH_FIELD_TOL (the now state in grid
    space) and MESH_AUX_TOL (aux); windows of T85_STEPS steps of the
    single-device model, the mesh model, the mesh model and the
    single-device model, timed, each mesh window with both kernels'
    launch counts and the transposes and halo calls set to 0 before and
    read after (exactly 24 B and 4 A launches per refresh).
    Last, after every timed run, so that no trace overlaps the timing,
    the kernel launches of one refresh and one plain step of each model,
    counted as profile_step counts them.  The process group is
    destroyed at the end.  Returns {kernel: launches} of the timed mesh
    runs."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from climt_tpu_torch.convert import carry_to_global, carry_to_numpy
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    from climt_tpu_torch.parallel import (dist_sht, halo,
                                          initialize_distributed, make_mesh)
    from climt_tpu_torch.profile_step import profile_one

    total = {k: 0 for k in counters}
    refreshes = sum(1 for k in range(T85_STEPS) if k % T85['rad_every'] == 0)
    traced = []             # (mode, model, step_fn, carry at k=T85_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        if initialize_distributed('file://' + os.path.join(tmp, 'store'), 1,
                                  0, device='cuda') != 1:
            fail('phase 20: a world of one did not start')
        try:
            if dist.get_backend() != 'nccl':
                fail('phase 20: backend %s, not nccl' % dist.get_backend())
            mesh = make_mesh(1)
            for mode in MESH_MODES:
                ref_dycore, init1, step1, _ = build_moist_gcm(
                    dtype=torch.float32, device=dev, moisture_advection=mode,
                    **T85)
                dycore, init_fn, step_fn, _ = build_moist_gcm(
                    mesh=mesh, dtype=torch.float32, device=dev,
                    moisture_advection=mode, **T85)
                ref = carry_to_numpy(step1(init1(0))[0])
                one = carry_to_global(step_fn(init_fn(0))[0], dycore.sht)
                worst = {}
                for name, b in ref[1].items():
                    a = one[1][name]
                    if np.iscomplexobj(b):
                        a, b = (ref_dycore.sht.synthesize(torch.as_tensor(
                            x, device=dev)).cpu().numpy() for x in (a, b))
                    worst[name] = check_close(a, b, MESH_FIELD_TOL,
                                              'phase 20 %s %s' % (mode, name))
                for name, b in ref[3].items():
                    worst['aux ' + name] = check_close(
                        one[3][name], b, MESH_AUX_TOL,
                        'phase 20 %s aux %s' % (mode, name))
                if int(one[4]) != int(ref[4]):
                    fail('phase 20 %s: step index %s, not %s' % (
                        mode, one[4], ref[4]))
                del ref, one

                # single-device, mesh, mesh, single-device windows of
                # T85_STEPS steps (two refreshes each), each model going on
                # from its own carry; the counts over the mesh windows
                carries = {'single-device': init1(0), 'mesh': init_fn(0)}
                seconds = {'single-device': [], 'mesh': []}
                diags = {}
                windows = []
                transposes = halos = 0
                for kind in ('single-device', 'mesh', 'mesh',
                             'single-device'):
                    torch.cuda.synchronize()
                    for counter in counters.values():
                        counter.launches = 0
                    dist_sht.transpose.calls = 0
                    halo.LatHalo.calls = 0
                    carries[kind], diags[kind], step_s = timed_steps(
                        step_fn if kind == 'mesh' else step1, carries[kind],
                        T85_STEPS, torch)
                    seconds[kind] += step_s
                    windows.append('%s %.4f' % (kind, sum(step_s) / len(
                        step_s)))
                    if kind != 'mesh':
                        continue
                    launches = {k: c.launches for k, c in counters.items()}
                    if launches != {'B': 24 * refreshes,
                                    'A': 4 * refreshes}:
                        fail('phase 20 %s: kernel launches A=%d B=%d in %d '
                             'refreshes, not 4 and 24 each' % (
                                 mode, launches['A'], launches['B'],
                                 refreshes))
                    for k in total:
                        total[k] += launches[k]
                    transposes += dist_sht.transpose.calls
                    halos += halo.LatHalo.calls
                carry = carries['mesh']
                T = dycore.sht.synthesize(carry[1]['T'])
                for key, val in [('T', T)] + list(diags['mesh'].items()):
                    if not bool(torch.isfinite(val).all()):
                        fail('phase 20 %s: NaN or inf in %s' % (mode, key))
                if not 150.0 < float(T.min()) < float(T.max()) < 350.0:
                    fail('phase 20 %s: T in [%g, %g]' % (
                        mode, float(T.min()), float(T.max())))
                traced += [(mode, 'mesh', step_fn, carry),
                           (mode, 'single-device', step1,
                            carries['single-device'])]
                phase(20, 'world of one NCCL rank, T85 f32 %r, one step '
                      'against the single-device model: largest difference '
                      'over its limit %.3g (%s; limits rtol %g atol %g, aux '
                      'rtol %g atol %g)' % (
                          mode, max(worst.values()),
                          max(worst, key=worst.get),
                          MESH_FIELD_TOL['rtol'], MESH_FIELD_TOL['atol'],
                          MESH_AUX_TOL['rtol'], MESH_AUX_TOL['atol']))
                mesh_steps = len(seconds['mesh'])
                phase(20, 'world of one, T85 f32 %r, %d-step windows (%s '
                      's/step): mesh %.4f s/step, single-device %.4f, over '
                      'two windows each (phase 6 %.4f); per refresh kernel '
                      'B %g, kernel A %g; per step %g all_to_all '
                      'transposes, %g halo calls; on %s' % (
                          mode, T85_STEPS, ', '.join(windows),
                          sum(seconds['mesh']) / mesh_steps,
                          sum(seconds['single-device']) / len(
                              seconds['single-device']), phase6_s,
                          launches['B'] / refreshes,
                          launches['A'] / refreshes, transposes / mesh_steps,
                          halos / mesh_steps, card))
                del ref_dycore, init1, dycore, init_fn, diags, T
                torch.cuda.empty_cache()
            for mode, kind, step_fn, carry in traced:
                # k = 2 T85_STEPS is a refresh step, the next a plain one
                carry, refresh_s, refresh_busy, refresh, _ = profile_one(
                    step_fn, carry)
                _, plain_s, plain_busy, plain, _ = profile_one(step_fn, carry)
                phase(20, 'T85 f32 %r %s model: %d kernel launches per '
                      'refresh step, %d per plain step (traced walls %.4f, '
                      '%.4f s; kernel time %.4f, %.4f s); on %s' % (
                          mode, kind, refresh, plain, refresh_s, plain_s,
                          refresh_busy, plain_busy, card))
            del traced
        finally:
            dist.destroy_process_group()
    return total


def mesh_shared_card_phase(dev, card):
    """Phase 20 (b): two spawned ranks on the one card with the gloo
    backend (NCCL refuses two ranks on one GPU), the moist GCM at
    SHARED_CARD float64 for 7 steps with SHARED_CARD_MODES moisture, each
    rank's gathered carry and diagnostics against the single-device card
    run within SHARED_CARD_TOL of max."""
    import tempfile

    import torch
    from climt_tpu_torch.convert import carry_to_numpy
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    from torch_helpers import rel_err, spawn_ranks

    refs, single_s = {}, {}
    for mode in SHARED_CARD_MODES:
        t0 = time.perf_counter()
        _, init_fn, _, run_fn = build_moist_gcm(
            dtype=torch.float64, device=dev, moisture_advection=mode,
            **SHARED_CARD)
        carry, diag = run_fn(init_fn(0), 7)
        refs[mode] = carry_to_numpy(carry + (diag,))
        single_s[mode] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn_ranks('shared_card_rank', 2, tmp, timeout=600.0,
                            kw=SHARED_CARD, steps=7, modes=SHARED_CARD_MODES)
        spawn_s = time.perf_counter() - t0
    for mode in SHARED_CARD_MODES:
        worst = 0.0
        for rank, out in enumerate(ranks):
            got, _ = out[mode]
            for i in (0, 1, 2, 3, 5):
                for key, b in refs[mode][i].items():
                    err = rel_err(got[i][key], b)
                    if not err <= SHARED_CARD_TOL:
                        fail('phase 20 shared card %s rank %d: %s %s '
                             'differs by %.3g of max' % (mode, rank, i, key,
                                                         err))
                    worst = max(worst, err)
        phase(20, 'two gloo ranks on one card, %dx%dx%d f64 %r, 7 steps: '
              'largest difference from the single-device card run %.3g of '
              'max (limit %g); build, start and 7 steps %.2f s per rank '
              '(single device %.2f s); the spawn %.1f s in all; on %s' % (
                  SHARED_CARD['nlon'], SHARED_CARD['nlat'],
                  SHARED_CARD['nz'], mode, worst, SHARED_CARD_TOL,
                  max(out[mode][1] for out in ranks), single_s[mode],
                  spawn_s, card))


def layout_world_of_one_phase(dev, card, counters):
    """Phase 21 (a): one NCCL rank in this process, the T85 moist GCM of
    phase 6 built without a mesh (spectral moisture, float32), its carry
    placed by shard_model_state on make_mesh(1), with shard_lon False and
    True. For each layout: one step of the placed carry from seed 0
    against the single-device step within MESH_FIELD_TOL (the now state in
    grid space) and MESH_AUX_TOL (aux). Then windows of T85_STEPS steps of
    the one-device model, the two replicated layouts, the m-sharded model
    (build_moist_gcm(mesh=...)) and the one-device model again, timed step
    by step, each going on from its own carry, with both kernels' launches
    and the layout's all_reduce and all_gather calls set to 0 before each
    window and read after (exactly 24 B and 4 A launches per refresh in
    the replicated windows). Last, the kernel launches and kernel time of
    one refresh and one plain step of each replicated layout, as
    profile_step counts them (phase 20 counts the one-device model's). The
    process group is destroyed at the end. Returns {kernel: launches} of
    the replicated windows."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from climt_tpu_torch.convert import carry_to_global, carry_to_numpy
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    from climt_tpu_torch.parallel import rep_sht, shard_model_state
    from climt_tpu_torch.profile_step import profile_one, world_of_one

    total = {k: 0 for k in counters}
    refreshes = sum(1 for k in range(T85_STEPS) if k % T85['rad_every'] == 0)
    layouts = {'replicated': False, 'replicated shard_lon': True}
    with world_of_one() as mesh:
        if dist.get_world_size() != 1 or dist.get_backend() != 'nccl':
            fail('phase 21: a world of %d %s ranks, not one NCCL rank' % (
                dist.get_world_size(), dist.get_backend()))
        dycore, init_fn, step_fn, _ = build_moist_gcm(
            dtype=torch.float32, device=dev, **T85)
        _, init_m, step_m, _ = build_moist_gcm(
            mesh=mesh, dtype=torch.float32, device=dev, **T85)
        ref = carry_to_numpy(step_fn(init_fn(0))[0])
        for label, shard_lon in layouts.items():
            one = carry_to_global(step_fn(shard_model_state(
                mesh, *init_fn(0), shard_lon=shard_lon))[0])
            worst = {}
            for name, b in ref[1].items():
                a = one[1][name]
                if np.iscomplexobj(b):
                    a, b = (dycore.sht.synthesize(torch.as_tensor(
                        x, device=dev)).cpu().numpy() for x in (a, b))
                worst[name] = check_close(a, b, MESH_FIELD_TOL,
                                          'phase 21 %s %s' % (label,
                                                              name))
            for name, b in ref[3].items():
                worst['aux ' + name] = check_close(
                    one[3][name], b, MESH_AUX_TOL,
                    'phase 21 %s aux %s' % (label, name))
            if int(one[4]) != int(ref[4]):
                fail('phase 21 %s: step index %s, not %s' % (
                    label, one[4], ref[4]))
            phase(21, 'world of one NCCL rank, T85 f32 %s, one step '
                  'against the single-device step: largest difference '
                  'over its limit %.3g (%s; limits rtol %g atol %g, aux '
                  'rtol %g atol %g)' % (
                      label, max(worst.values()),
                      max(worst, key=worst.get),
                      MESH_FIELD_TOL['rtol'], MESH_FIELD_TOL['atol'],
                      MESH_AUX_TOL['rtol'], MESH_AUX_TOL['atol']))
        del ref, one

        carries = {'one device': init_fn(0), 'm-sharded': init_m(0)}
        steps = {'one device': step_fn, 'm-sharded': step_m}
        for label, shard_lon in layouts.items():
            carries[label] = shard_model_state(mesh, *init_fn(0),
                                               shard_lon=shard_lon)
            steps[label] = step_fn
        seconds = {kind: [] for kind in carries}
        windows = []
        for kind in ('one device',) + tuple(layouts) + ('m-sharded',
                                                         'one device'):
            torch.cuda.synchronize()
            for counter in counters.values():
                counter.launches = 0
            rep_sht.all_reduce_sum.calls = 0
            rep_sht.all_gather_cat.calls = 0
            carries[kind], diag, step_s = timed_steps(
                steps[kind], carries[kind], T85_STEPS, torch)
            seconds[kind] += step_s
            windows.append('%s %.4f' % (kind, median(step_s)))
            if kind not in layouts:
                continue
            launches = {k: c.launches for k, c in counters.items()}
            if launches != {'B': 24 * refreshes, 'A': 4 * refreshes}:
                fail('phase 21 %s: kernel launches A=%d B=%d in %d '
                     'refreshes, not 4 and 24 each' % (
                         kind, launches['A'], launches['B'],
                         refreshes))
            for k in total:
                total[k] += launches[k]
            T = dycore.sht.synthesize(carries[kind][1]['T'].to_local())
            for key, val in [('T', T)] + [
                    (k, v.to_local()) for k, v in diag.items()]:
                if not bool(torch.isfinite(val).all()):
                    fail('phase 21 %s: NaN or inf in %s' % (kind, key))
            if not 150.0 < float(T.min()) < float(T.max()) < 350.0:
                fail('phase 21 %s: T in [%g, %g]' % (
                    kind, float(T.min()), float(T.max())))
            phase(21, 'T85 f32 %s: per refresh kernel B %g, kernel A '
                  '%g; per step %g all_reduce and %g all_gather calls; '
                  'on %s' % (
                      kind, launches['B'] / refreshes,
                      launches['A'] / refreshes,
                      rep_sht.all_reduce_sum.calls / T85_STEPS,
                      rep_sht.all_gather_cat.calls / T85_STEPS, card))
        phase(21, 'T85 f32, %d-step windows (median s/step: %s): '
              'medians over the windows %s; on %s' % (
                  T85_STEPS, ', '.join(windows), ', '.join(
                      '%s %.4f' % (kind, median(s))
                      for kind, s in seconds.items()), card))
        # k = T85_STEPS is a refresh step, the next a plain one; phase
        # 20 traces the one-device model in the same process
        for kind in layouts:
            carry, refresh_s, refresh_busy, refresh, _ = profile_one(
                step_fn, carries[kind])
            _, plain_s, plain_busy, plain, _ = profile_one(step_fn, carry)
            phase(21, 'T85 f32 %s model: %d kernel launches per refresh '
                  'step, %d per plain step (traced walls %.4f, %.4f s; '
                  'kernel time %.4f, %.4f s); on %s' % (
                      kind, refresh, plain, refresh_s, plain_s,
                      refresh_busy, plain_busy, card))
        del carries, carry, diag, T
        torch.cuda.empty_cache()
    return total


def layout_shared_card_phase(dev, card):
    """Phase 21 (b): two spawned ranks on the one card with the gloo
    backend, the moist GCM at LAYOUT_CARD float64 built without a mesh,
    its carry placed by shard_model_state on each mesh of
    LAYOUT_CARD_MESHES, with each mode of LAYOUT_CARD_MODES, 7 steps;
    each rank's gathered carry and diagnostics against the single-device
    card run within LAYOUT_CARD_TOL of max."""
    import tempfile

    import torch
    from climt_tpu_torch.convert import carry_to_numpy
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    from torch_helpers import rel_err, spawn_ranks

    refs, single_s = {}, {}
    for mode in LAYOUT_CARD_MODES:
        t0 = time.perf_counter()
        _, init_fn, _, run_fn = build_moist_gcm(
            dtype=torch.float64, device=dev, moisture_advection=mode,
            **LAYOUT_CARD)
        carry, diag = run_fn(init_fn(0), 7)
        refs[mode] = carry_to_numpy(carry + (diag,))
        single_s[mode] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn_ranks('layout_shared_card_rank', 2, tmp,
                            timeout=600.0, kw=LAYOUT_CARD, steps=7,
                            modes=LAYOUT_CARD_MODES,
                            meshes=LAYOUT_CARD_MESHES)
        spawn_s = time.perf_counter() - t0
    for shape, shard_lon in LAYOUT_CARD_MESHES:
        for mode in LAYOUT_CARD_MODES:
            key, worst = (shape, shard_lon, mode), 0.0
            for rank, out in enumerate(ranks):
                got, _ = out[key]
                for i in (0, 1, 2, 3, 5):
                    for name, b in refs[mode][i].items():
                        err = rel_err(got[i][name], b)
                        if not err <= LAYOUT_CARD_TOL:
                            fail('phase 21 shared card %s %r rank %d: %s %s '
                                 'differs by %.3g of max' % (
                                     shape, mode, rank, i, name, err))
                        worst = max(worst, err)
            phase(21, 'two gloo ranks on one card, mesh %s shard_lon=%s, '
                  '%dx%dx%d f64 %r, 7 steps: largest difference from the '
                  'single-device card run %.3g of max (limit %g); build, '
                  'place and 7 steps %.2f s per rank (single device %.2f '
                  's); the spawn %.1f s in all; on %s' % (
                      shape, shard_lon, LAYOUT_CARD['nlon'],
                      LAYOUT_CARD['nlat'], LAYOUT_CARD['nz'], mode, worst,
                      LAYOUT_CARD_TOL, max(out[key][1] for out in ranks),
                      single_s[mode], spawn_s, card))


def verbose_examples_phase(card):
    """Phase 22: each example of VERBOSE_EXAMPLES as written, on the card,
    with verbose=True: its printout reads card fields through np.asarray
    (a DataArray's HostTensor values).  Checks the printed lines."""
    import contextlib
    import io

    from torch_helpers import port_example

    for name, kw in VERBOSE_EXAMPLES:
        main, _ = port_example(name)
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            main(verbose=True, **kw)
        lines = printed.getvalue().splitlines()
        if not lines or any('nan' in line.lower() for line in lines):
            fail('phase 22 %s: printed %r' % (name, lines))
        phase(22, '%s %s verbose=True on the card, %.2f s: %d lines, the '
              'last %r; on %s' % (name, kw, time.perf_counter() - t0,
                                  len(lines), lines[-1], card))


def cork_setup(name, device, size, diagnostics_level=0, nudge=False):
    """(component, state) of one CORK_CASES case on ``device``: the
    CorkLongwaveRadiation of that table (or the Parmentier optics) and a
    default nx x ny x nz float64 state with tests/torch_helpers.py's
    cork_fields from seed 0 (a lapse-rate temperature, humidity, CO2,
    emissivity 0.90-0.99, cloud in levels 5-8), irradiation 1200 K and
    internal temperature 100 K.  With ``nudge`` the air temperature is one
    ulp higher.  The fields the component reads are moved to ``device``
    first, as a model's state holds them."""
    import numpy as np
    import torch

    import climt_tpu_torch as ct
    from climt_tpu_torch.components.cork.lw import CorkLongwaveRadiation
    from torch_helpers import cork_fields

    kw = (dict(optics='parmentier') if name == 'parmentier'
          else dict(table=name))
    comp = CorkLongwaveRadiation(device=device,
                                 diagnostics_level=diagnostics_level, **kw)
    nx, ny, nz = size
    state = ct.get_default_state([comp], grid_state=ct.get_grid(
        nx=nx, ny=ny, nz=nz))
    fields = cork_fields(state, np.random.RandomState(0))
    fields.update(irradiation_temperature=1200.0, internal_temperature=100.0)
    for key, value in fields.items():
        if key in state:
            state[key].values[:] = value
    if nudge:
        nudge_temperature(state)
    for key in comp.input_properties:
        state[key].values = torch.as_tensor(state[key].values,
                                            device=device)
    return comp, state


def cork_outputs(comp, state, torch, label):
    """{name: tensor} of one call's tendency and diagnostics, checked
    finite, with every flux non-negative."""
    tendencies, diagnostics = comp(state)
    out = finite_float_fields(diagnostics, torch, label)
    out.update({'tendency of ' + k: v for k, v in finite_float_fields(
        tendencies, torch, label).items()})
    for name, value in out.items():
        if 'flux' in name and not float(value.min()) >= 0.0:
            fail('%s: %s has a negative flux %g' % (label, name,
                                                    float(value.min())))
    return out


def cork_phase(dev, card, counters):
    """Phase 23: CORK longwave radiation.  (a) Every shipped LW k-table at
    its own band and g-point count, and the Parmentier optics, on one
    CORK_SIZE float64 state (cork_setup): a warm-up call and CORK_CALLS
    timed calls (ms per call), the device operations one call launches
    (torch.profiler), every field finite and every flux non-negative;
    (b) earth_low_res_lw at CORK_T85 with diagnostics_level 0 and 1: s
    per call and the peak memory a call adds; (c) each case of (a) at
    CORK_SMALL with diagnostics_level 1 on the card against the CPU,
    within 10 times the larger of SPREAD_FLOOR and the spread that one
    ulp more air temperature makes on the CPU.  CORK launches neither
    kernel: fails if kernel A or B launched in (a) or (b).  Restores the
    longwave band count that the CORK components declare."""
    import torch
    from climt_tpu_torch.core import initialization

    band_count = initialization._num_longwave_bands
    for counter in counters.values():
        counter.launches = 0
    for name in CORK_CASES:
        comp, state = cork_setup(name, dev, CORK_SIZE)
        secs = []
        for _ in range(CORK_CALLS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cork_outputs(comp, state, torch, name)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = device_launches(lambda: comp(state), torch)
        olr = out['upwelling_longwave_flux_in_air'][-1]
        bands = (2, 1) if name == 'parmentier' else (
            comp.num_longwave_bands, comp._num_gpts)
        phase(23, '%s %dx%dx%d f64, %d bands x %d g-points: %.3f ms/call '
              '[min %.3f, max %.3f; first %.3f], %d device operations a '
              'call; OLR %.1f-%.1f W/m^2; on %s' % (
                  name, *CORK_SIZE, *bands, 1e3 * median(secs[1:]),
                  1e3 * min(secs[1:]), 1e3 * max(secs[1:]), 1e3 * secs[0],
                  launches, float(olr.min()), float(olr.max()), card))
        del comp, state, out
    for level in (0, 1):
        comp, state = cork_setup('earth_low_res_lw', dev, CORK_T85, level)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cork_outputs(comp, state, torch, 'earth_low_res_lw T85')
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            del out
        peak = torch.cuda.max_memory_allocated()
        phase(23, 'earth_low_res_lw %dx%dx%d f64 diagnostics_level %d: '
              '%.4f s/call [first %.4f], peak memory %.2f GB (%.2f GB above '
              'the state and tables); on %s' % (
                  *CORK_T85, level, median(secs[1:]), secs[0], peak / 1e9,
                  (peak - before) / 1e9, card))
        del comp, state
        torch.cuda.empty_cache()
    if any(c.launches for c in counters.values()):
        fail('phase 23: CORK launched kernel A %d, B %d times' % (
            counters['A'].launches, counters['B'].launches))

    cpu = torch.device('cpu')
    worst_case = (0.0, None)
    for name in CORK_CASES:
        runs = {}
        for label, device, nudge in (('cpu', cpu, False), ('nudged', cpu, True),
                                     ('card', dev, False)):
            comp, state = cork_setup(name, device, CORK_SMALL, 1, nudge)
            runs[label] = cork_outputs(comp, state, torch, name)
        spread = largest_difference(runs['nudged'], runs['cpu'])
        limit = 10.0 * max(spread, SPREAD_FLOOR)
        worst = largest_difference(runs['card'], runs['cpu'])
        if not worst <= limit:
            fail('phase 23 %s: the card differs from the CPU by %.3g of '
                 'max, more than %.3g (10 x the one-ulp spread %.3g, floor '
                 '%.3g)' % (name, worst, limit, spread, SPREAD_FLOOR))
        phase(23, '%s %dx%dx%d f64 diagnostics_level 1, card against the '
              'CPU: %.3g of max, limit %.3g (one-ulp spread %.3g)' % (
                  name, *CORK_SMALL, worst, limit, spread))
    initialization._num_longwave_bands = band_count


def matmul_dft_phase(dev, card, counters, init_fft, step_fft):
    """Phase 24: the matmul zonal DFT.  The T85 moist GCM of phase 6 built
    with fft_impl='matmul' (float32): one step from seed 0, every field of
    the now state (in grid space) and of aux within MATMUL_RATIO times
    the larger of FLOAT32_EPS and the distance of phase 6's fft model
    (``init_fft``, ``step_fft``) from the float64 fft model's step, as a
    distance from that step (max |a - b| / max |b|).  The two float32
    DFTs round differently, and the physics' thresholds (convection,
    RRTMG's reference levels) turn that into differences beyond
    MESH_FIELD_TOL and MESH_AUX_TOL in a few columns (q 3.19 times its
    limit at T85 on an H100), as they do between either float32 model
    and the float64 one.  Then windows of T85_STEPS steps of the fft
    model, the matmul model, the matmul model and the fft model, each
    going on from its own carry, timed step by step, with both kernels'
    launch counts set to 0 before each matmul window and read after it
    (exactly 24 B and 4 A launches per refresh).  Then the model at
    GRID_SMALL, float64, 7 steps on the card against the CPU within
    SMALL_TOL; then phase 21 (a)'s replicated layout (one NCCL rank,
    shard_lon False and True) with the matmul DFT: one step against the
    single-device matmul step within MESH_FIELD_TOL and MESH_AUX_TOL."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from climt_tpu_torch.convert import carry_to_global, carry_to_numpy
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    from climt_tpu_torch.parallel import shard_model_state
    from climt_tpu_torch.profile_step import world_of_one

    def grid_fields(carry):
        """{name: float64 numpy} of a numpy carry's now state in grid space
        (synthesized in float64), and its aux."""
        out = {'aux ' + k: np.float64(v) for k, v in carry[3].items()}
        for name, v in carry[1].items():
            out[name] = (sht64.synthesize(torch.as_tensor(
                v, device=dev).to(torch.complex128)).cpu().numpy()
                if np.iscomplexobj(v) else np.float64(v))
        return out

    def one_step_against(ref, got, sht, label):
        worst = {}
        for name, b in ref[1].items():
            a = got[1][name]
            if np.iscomplexobj(b):
                a, b = (sht.synthesize(torch.as_tensor(
                    x, device=dev)).cpu().numpy() for x in (a, b))
            worst[name] = check_close(a, b, MESH_FIELD_TOL,
                                      'phase 24 %s %s' % (label, name))
        for name, b in ref[3].items():
            worst['aux ' + name] = check_close(
                got[3][name], b, MESH_AUX_TOL,
                'phase 24 %s aux %s' % (label, name))
        if int(got[4]) != int(ref[4]):
            fail('phase 24 %s: step index %s, not %s' % (label, got[4],
                                                         ref[4]))
        return max(worst.values()), max(worst, key=worst.get)

    total = {k: 0 for k in counters}
    refreshes = sum(1 for k in range(T85_STEPS) if k % T85['rad_every'] == 0)
    dycore64, init64, step64, _ = build_moist_gcm(
        dtype=torch.float64, device=dev, **T85)
    sht64 = dycore64.sht
    ref64 = grid_fields(carry_to_numpy(step64(init64(0))[0]))
    del dycore64, init64, step64
    torch.cuda.empty_cache()
    dycore, init_fn, step_fn, _ = build_moist_gcm(
        dtype=torch.float32, device=dev, fft_impl='matmul', **T85)
    if dycore.sht.fft_impl != 'matmul':
        fail('phase 24: the model transforms with %r' % dycore.sht.fft_impl)
    fft = carry_to_numpy(step_fft(init_fft(0))[0])
    mm = carry_to_numpy(step_fn(init_fn(0))[0])
    if int(mm[4]) != int(fft[4]):
        fail('phase 24: step index %s, not %s' % (mm[4], fft[4]))
    grids = {'fft': grid_fields(fft), 'matmul': grid_fields(mm)}
    err, ratios, apart = {}, {}, {}
    for name, b in ref64.items():
        scale = np.abs(b).max()
        for label, g in grids.items():
            err[label, name] = float(np.abs(g[name] - b).max() / scale)
        apart[name] = float(np.abs(grids['matmul'][name]
                                   - grids['fft'][name]).max() / scale)
        ratios[name] = err['matmul', name] / max(err['fft', name],
                                                 FLOAT32_EPS)
    worst = max(ratios, key=ratios.get)
    phase(24, 'T85 f32 fft_impl=matmul, one step from seed 0: distance '
          'from the f64 fft step (of max) matmul/fft, and the matmul '
          'step\'s difference from the fft step: %s; on %s' % (
              ', '.join('%s %.3g/%.3g (%.3g)' % (
                  name, err['matmul', name], err['fft', name], apart[name])
                  for name in ref64), card))
    if not ratios[worst] <= MATMUL_RATIO:
        fail('phase 24: one step of the matmul model is %.3g of max from '
             'the float64 model in %s, %.3g times the fft model\'s %.3g '
             '(limit %g)' % (err['matmul', worst], worst, ratios[worst],
                             err['fft', worst], MATMUL_RATIO))
    phase(24, 'T85 f32 fft_impl=matmul: largest ratio of the distances '
          'from the f64 step %.3g (%s; limit %g, floor %.3g of max)' % (
              ratios[worst], worst, MATMUL_RATIO, FLOAT32_EPS))
    del fft, mm, ref64, grids, sht64

    carries = {'fft': init_fft(0), 'matmul': init_fn(0)}
    steps = {'fft': step_fft, 'matmul': step_fn}
    seconds = {'fft': [], 'matmul': []}
    windows = []
    for kind in ('fft', 'matmul', 'matmul', 'fft'):
        torch.cuda.synchronize()
        for counter in counters.values():
            counter.launches = 0
        carries[kind], diag, step_s = timed_steps(steps[kind], carries[kind],
                                                  T85_STEPS, torch)
        seconds[kind] += step_s
        windows.append('%s %.4f' % (kind, median(step_s)))
        if kind != 'matmul':
            continue
        launches = {k: c.launches for k, c in counters.items()}
        if launches != {'B': 24 * refreshes, 'A': 4 * refreshes}:
            fail('phase 24: kernel launches A=%d B=%d in %d refreshes, not '
                 '4 and 24 each' % (launches['A'], launches['B'], refreshes))
        for k in total:
            total[k] += launches[k]
        T = dycore.sht.synthesize(carries[kind][1]['T'])
        for key, val in [('T', T)] + list(diag.items()):
            if not bool(torch.isfinite(val).all()):
                fail('phase 24: NaN or inf in %s' % key)
        if not 150.0 < float(T.min()) < float(T.max()) < 350.0:
            fail('phase 24: T in [%g, %g]' % (float(T.min()),
                                               float(T.max())))
    phase(24, 'T85 f32, %d-step windows (median s/step: %s): matmul %.4f '
          's/step, fft %.4f (medians over two windows each); per refresh '
          'kernel B %g, kernel A %g; on %s' % (
              T85_STEPS, ', '.join(windows), median(seconds['matmul']),
              median(seconds['fft']), total['B'] / (2 * refreshes),
              total['A'] / (2 * refreshes), card))
    del carries, steps, diag, T
    torch.cuda.empty_cache()

    finals = {}
    for label, where in (('cpu', torch.device('cpu')), ('card', dev)):
        _, small_init, _, small_run = build_moist_gcm(
            device=where, dtype=torch.float64, fft_impl='matmul',
            **GRID_SMALL)
        finals[label] = carry_to_numpy(small_run(small_init(0), 7)[0])[2]
    diffs = {}
    for key, tol in SMALL_TOL.items():
        a, b = finals['card'][key], finals['cpu'][key]
        if not np.isfinite(a).all():
            fail('phase 24: non-finite %s on the card' % key)
        diffs[key] = float(np.abs(a - b).max())
        if not diffs[key] <= tol:
            fail('phase 24: %s differs by %g > %g' % (key, diffs[key], tol))
    phase(24, '%dx%dx%d f64 fft_impl=matmul, 7 steps, card against the '
          'CPU, max abs diff: %s (limits %s)' % (
              GRID_SMALL['nlon'], GRID_SMALL['nlat'], GRID_SMALL['nz'],
              ', '.join('%s %.3g' % kv for kv in diffs.items()),
              ', '.join('%s %g' % kv for kv in SMALL_TOL.items())))

    with world_of_one() as mesh:
        if dist.get_world_size() != 1 or dist.get_backend() != 'nccl':
            fail('phase 24: a world of %d %s ranks, not one NCCL rank' % (
                dist.get_world_size(), dist.get_backend()))
        ref = carry_to_numpy(step_fn(init_fn(0))[0])
        for shard_lon in (False, True):
            got = carry_to_global(step_fn(shard_model_state(
                mesh, *init_fn(0), shard_lon=shard_lon))[0])
            worst, where = one_step_against(
                ref, got, dycore.sht, 'replicated shard_lon=%s' % shard_lon)
            phase(24, 'world of one NCCL rank, T85 f32 fft_impl=matmul, '
                  'replicated shard_lon=%s, one step against the '
                  'single-device step: largest difference over its limit '
                  '%.3g (%s); on %s' % (shard_lon, worst, where, card))
    del dycore, init_fn, step_fn, ref, got
    torch.cuda.empty_cache()


def rrtmg_lw_setup(device, nudge=False, size=KTABLE_SMALL):
    """(component, state) of RRTMGLongwave on ``device`` and a default
    nx x ny x nz float64 state with cloud in layers 3-4 (fraction 0.5, ice
    0.3 g/m^2), the fields it reads on ``device``; with ``nudge`` the air
    temperature is one ulp higher."""
    import torch

    import climt_tpu_torch as ct

    comp = ct.RRTMGLongwave(device=device)
    nx, ny, nz = size
    state = ct.get_default_state([comp], grid_state=ct.get_grid(
        nx=nx, ny=ny, nz=nz))
    state['cloud_area_fraction_in_atmosphere_layer'].values[3:5] = 0.5
    state['mass_content_of_cloud_ice_in_atmosphere_layer'].values[3:5] = 0.3
    if nudge:
        nudge_temperature(state)
    for key in comp.input_properties:
        state[key].values = torch.as_tensor(state[key].values,
                                            device=device)
    return comp, state


def rrtmg_lw_outputs(device, nudge=False):
    """{name: tensor} of one ``rrtmg_lw_setup`` call's tendency and
    diagnostics, checked finite."""
    import torch

    comp, state = rrtmg_lw_setup(device, nudge)
    tendencies, diagnostics = comp(state)
    out = finite_float_fields(diagnostics, torch, 'RRTMGLongwave')
    out.update({'tendency of ' + k: v for k, v in finite_float_fields(
        tendencies, torch, 'RRTMGLongwave').items()})
    return out


def ktables_phase(dev, card, counters, init_fn, step_fn, report):
    """Phase 25: installed LW k-tables through kernel B (see the module
    docstring).  ``report`` holds phase 3's surrogate records.  Returns
    (b)'s launch counts."""
    import tempfile

    import torch
    from climt_tpu_torch.components.rrtmg import fused_mix
    from climt_tpu_torch.components.rrtmg import lw_spectral as LW
    from torch_helpers import seeded_lw_tables

    t_phase = time.perf_counter()
    f32 = torch.float32
    chunk = t85_chunk(step_fn, init_fn, dev)
    cs, wx = chunk_lw_coefs(chunk)
    LW._KDIST_OVERRIDE[0] = None
    surrogate = LW.load_kdist()
    before = {'chunk': [x.clone() for x in chunk_lw_fluxes(chunk)],
              'component': rrtmg_lw_outputs(dev)}
    carry0 = init_fn(0)
    _, diag_s = step_fn(carry0)
    torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        tables = LW.load_aer_tables(
            seeded_lw_tables(os.path.join(tmp, 'seeded.npz'), seed=0))
    if LW.load_kdist() is not tables:
        fail('phase 25: load_aer_tables did not install the tables')

    # (a) the LW groups on the installed tables, the first call packing
    def lw_groups():
        return dict(zip(('lw_taug', 'lw_fracs'),
                        (g.finish() for g in LW.taumol_lw_terms(cs, wx,
                                                                f32))))

    timings = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        groups = lw_groups()
        torch.cuda.synchronize()
        timings.append(time.perf_counter() - t0)
    # the packing alone, from the bands and parts a call writes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for group in LW.taumol_lw_terms(cs, wx, f32):
        fused_mix.Layout(group.ngs, group.parts, f32, dev, tables)
    torch.cuda.synchronize()
    timings.append(time.perf_counter() - t0)
    for layout, _, _ in groups.values():
        if layout.source is not tables:
            fail('phase 25: a float32 LW group packed the old tables')
    rec32 = kernel_b_groups(groups, 1e-6, card, torch, n=25)
    del groups
    f64 = {k: v for k, v in example_f64_groups().items()
           if k in ('lw_taug', 'lw_fracs')}
    for layout, _, _ in f64.values():
        if layout.source is not tables:
            fail('phase 25: a float64 LW group packed the old tables')
    rec64 = kernel_b_groups(f64, 1e-12, card, torch, n=25)
    del f64
    for label, rec, old in (('float32 T85 chunk', rec32, report['B']),
                            ('float64 example', rec64, report['B_f64'])):
        phase(25, 'kernel B %s on the installed tables: %s; phase 3 on the '
              'surrogate: %s; on %s' % (label, ', '.join(
                  '%s %.4f ms' % (k, rec['groups'][k]['ms'])
                  for k in ('lw_taug', 'lw_fracs')), ', '.join(
                  '%s %.4f ms' % (k, old['groups'][k]['ms'])
                  for k in ('lw_taug', 'lw_fracs')), card))
    phase(25, 'float32 LW groups built and finished: first call after the '
          'install %.2f ms, second %.2f ms; packing both groups\' tables '
          'alone %.2f ms' % tuple(1e3 * t for t in timings))

    # (b) one T85 refresh step on the installed tables
    carry0 = init_fn(0)
    torch.cuda.synchronize()
    for counter in counters.values():
        counter.launches = 0
    t0 = time.perf_counter()
    carry, diag = step_fn(carry0)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    if launches != {'A': 4, 'B': 24}:
        fail('phase 25: a T85 refresh step launched %s, not A=4, B=24'
             % launches)
    T_grid = step_fn.__self__.dycore.sht.synthesize(carry[1]['T'])
    for key, val in [('T', T_grid)] + list(diag.items()):
        if not bool(torch.isfinite(val).all()):
            fail('phase 25: NaN or inf in %s' % key)
    if not (150.0 < float(T_grid.min()) and float(T_grid.max()) < 350.0):
        fail('phase 25: temperature out of range [%g, %g]' % (
            float(T_grid.min()), float(T_grid.max())))
    olr_err, olr_scale = max_rel_err(diag['olr'], diag_s['olr'])
    if not olr_err > 1e-4 * olr_scale:
        fail('phase 25: the installed tables moved OLR by %g of max only'
             % (olr_err / olr_scale))
    phase(25, 'T85 refresh step on the installed tables: %.4f s, launches '
          'A=%d B=%d, T in [%.1f, %.1f] K, OLR %.4g of max from the '
          'surrogate step\'s; on %s' % (
              step_s, launches['A'], launches['B'], float(T_grid.min()),
              float(T_grid.max()), olr_err / olr_scale, card))
    del carry, carry0, diag, diag_s, T_grid

    # (c) RRTMGLongwave on the card against the CPU
    cpu = torch.device('cpu')
    host = rrtmg_lw_outputs(cpu)
    spread = largest_difference(rrtmg_lw_outputs(cpu, nudge=True), host)
    limit = 10.0 * max(spread, SPREAD_FLOOR)
    installed_card = rrtmg_lw_outputs(dev)
    worst = largest_difference(installed_card, host)
    if not worst <= limit:
        fail('phase 25: RRTMGLongwave on the installed tables differs from '
             'the CPU by %.3g of max, more than %.3g (10 x the one-ulp '
             'spread %.3g, floor %.3g)' % (worst, limit, spread,
                                           SPREAD_FLOOR))
    moved = largest_difference(installed_card, before['component'])
    phase(25, 'RRTMGLongwave %dx%dx%d f64 on the installed tables, card '
          'against the CPU: %.3g of max, limit %.3g (one-ulp spread %.3g); '
          '%.3g of max from the surrogate' % (
              *KTABLE_SMALL, worst, limit, spread, moved))

    # (d) the override removed: the surrogate's results, bitwise
    LW._KDIST_OVERRIDE[0] = None
    after = {'chunk': chunk_lw_fluxes(chunk),
             'component': rrtmg_lw_outputs(dev)}
    if LW.load_kdist() is not surrogate:
        fail('phase 25: load_kdist did not go back to the surrogate')
    if not all(torch.equal(a, b) for a, b in zip(after['chunk'],
                                                  before['chunk'])):
        fail('phase 25: the T85 chunk\'s LW fluxes after the override was '
             'removed differ from the pre-install ones')
    for name, ref in before['component'].items():
        if not torch.equal(after['component'][name], ref):
            fail('phase 25: RRTMGLongwave %s after the override was removed '
                 'differs from the pre-install one' % name)
    stale = [key for key, layout in fused_mix.Group._LAYOUTS.items()
             if key[2] == str(dev) and layout.source is tables]
    if stale:
        fail('phase 25: card layouts still packed from the installed '
             'tables: %s' % stale)
    phase(25, 'override removed: T85 chunk LW fluxes and RRTMGLongwave '
          'outputs equal the pre-install ones bitwise; phase 25 in %.1f s'
          % (time.perf_counter() - t_phase))
    return launches


@contextlib.contextmanager
def captured_launches():
    """{'B': [(layout, idx, w)], 'A': [args]}: the inputs of every kernel-B
    and kernel-A launch made in the block, cloned (a group reuses its
    buffers), taken where the dispatchers call the wrappers; the wrappers
    launch as usual, and count on the stand-ins that their module names
    hold meanwhile, which carry the counts over both ways."""
    import torch
    from climt_tpu_torch.components.rrtmg import fused_mix, rtrn_kernel

    seen = {'B': [], 'A': []}
    mix, rtrn = fused_mix.mix_groups_cuda, rtrn_kernel.rtrn_lw_cuda

    def mix_seen(layout, idx, w):
        seen['B'].append((layout, idx.clone(), w.clone()))
        return mix(layout, idx, w)

    def rtrn_seen(*args):
        seen['A'].append(tuple(a.clone() if torch.is_tensor(a) else a
                               for a in args))
        return rtrn(*args)

    mix_seen.launches, rtrn_seen.launches = mix.launches, rtrn.launches
    fused_mix.mix_groups_cuda, rtrn_kernel.rtrn_lw_cuda = mix_seen, rtrn_seen
    try:
        yield seen
    finally:
        fused_mix.mix_groups_cuda, rtrn_kernel.rtrn_lw_cuda = mix, rtrn
        mix.launches, rtrn.launches = mix_seen.launches, rtrn_seen.launches


def group_name(layout):
    """The name of the group whose cached layout ``layout`` is."""
    from climt_tpu_torch.components.rrtmg import fused_mix

    key = next(k for k, v in fused_mix.Group._LAYOUTS.items()
               if v is layout)[0]
    return key if isinstance(key, str) else key[0]


def kernel_a_check(args, tol, card, torch, n):
    """Phase ``n``: kernel A on ``args`` (rtrn_lw_cuda's, rec_6 last)
    against its plain version within tol of max for each flux, timed
    beside its bound and the plain version.  Returns the record."""
    from climt_tpu_torch.components.rrtmg import rtrn_kernel

    nz, ncol = args[0].shape[:2]
    outs = rtrn_kernel.rtrn_lw_cuda(*args)
    refs = rtrn_kernel.rtrn_lw_plain(*args)
    torch.cuda.synchronize()
    worst = worst_rel = 0.0
    for o, rf, nm in zip(outs, refs, ('up', 'dn', 'up_clr', 'dn_clr')):
        err, scale = max_rel_err(o, rf)
        if not err <= tol * scale:
            fail('kernel A disagrees at nz=%d ncol=%d (%s): %g > %g * %g'
                 % (nz, ncol, nm, err, tol, scale))
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / scale)
    ms = cuda_ms(lambda: rtrn_kernel.rtrn_lw_cuda(*args), 10, torch)
    plain_ms = cuda_ms(lambda: rtrn_kernel.rtrn_lw_plain(*args), 3, torch)
    # each input read once, each output written once
    nbytes = (sum(a.numel() for a in args[:-1]) + 4 * (nz + 1) * ncol) * 4
    bound_ms, bound_by = bound(nbytes, RTRN_OPS_PER_POINT * 140 * nz * ncol)
    phase(n, 'kernel A nz=%d ncol=%d: max abs err %.3g W/m^2 (%.3g of max, '
          'limit %g), %.4f ms, plain %.4f ms, bound %.4f ms (%s, %.1f MB), '
          '%.0f%% of bound; on %s' % (
              nz, ncol, worst, worst_rel, tol, ms, plain_ms, bound_ms,
              bound_by, nbytes / 1e6, 100.0 * bound_ms / ms, card))
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms)


def entry_points_phase(dev, card, counters):
    """Phase 26: the repository's two entry points on the port (see the
    module docstring).  Returns (a)'s launch counts and the records of
    both kernels held against their plain versions at (a)'s shapes."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from climt_tpu_torch import entry_points
    from climt_tpu_torch.ops.sht import SphericalHarmonicTransform

    seconds = {}
    t0 = time.perf_counter()
    fn, (carry,) = entry_points.entry()
    torch.cuda.synchronize()
    seconds['entry()'] = time.perf_counter() - t0
    for counter in counters.values():
        counter.launches = 0
    t0 = time.perf_counter()
    spec = fn(carry)
    torch.cuda.synchronize()
    seconds['fn(carry)'] = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    if launches != {'B': 6, 'A': 1}:
        fail('phase 26: entry() step launched kernel A %d and B %d times, '
             'not 1 and 6' % (launches['A'], launches['B']))
    t0 = time.perf_counter()
    fn(carry)
    torch.cuda.synchronize()
    seconds['fn(carry) again'] = time.perf_counter() - t0
    # each kernel against its plain version on the inputs the step gives
    # it, at the step's shapes (nz 10, its one column chunk)
    with captured_launches() as seen:
        fn(carry)
        torch.cuda.synchronize()
    if (len(seen['B']), len(seen['A'])) != (6, 1):
        fail('phase 26: the captured step made %d B and %d A launches'
             % (len(seen['B']), len(seen['A'])))
    checked = dict(B=kernel_b_groups(
        {group_name(g[0]): g for g in seen['B']}, 1e-6, card, torch, n=26),
        A=kernel_a_check(seen['A'][0], 2e-6, card, torch, n=26))
    del seen
    if not (spec.is_cuda and spec.dtype == torch.complex64
            and bool(torch.isfinite(torch.view_as_real(spec)).all())):
        fail('phase 26: entry() step gave %s %s, not a finite complex64 '
             'CUDA tensor' % (spec.device, spec.dtype))
    sht = SphericalHarmonicTransform(32, 16, dtype=torch.float32, device=dev)
    T = sht.synthesize(spec)
    if not 150.0 < float(T.min()) < float(T.max()) < 350.0:
        fail('phase 26: entry() T in [%g, %g]' % (float(T.min()),
                                                   float(T.max())))
    t0 = time.perf_counter()
    fn_cpu, (carry_cpu,) = entry_points.entry(device='cpu')
    T_cpu = SphericalHarmonicTransform(32, 16, dtype=torch.float32,
                                       device='cpu').synthesize(
        fn_cpu(carry_cpu))
    seconds["entry(device='cpu') and fn"] = time.perf_counter() - t0
    diff = float(np.abs(T.cpu().numpy() - T_cpu.numpy()).max())
    if not diff <= SMALL_TOL['T']:
        fail('phase 26: entry() T differs from the CPU by %g K > %g'
             % (diff, SMALL_TOL['T']))
    phase(26, 'entry(): spectral T %s %s, grid T in [%.2f, %.2f] K; kernel '
          'B %d, kernel A %d launches; against the CPU step %.3g K (limit '
          '%g)' % (tuple(spec.shape), spec.dtype, float(T.min()),
                   float(T.max()), launches['B'], launches['A'], diff,
                   SMALL_TOL['T']))

    if dist.is_initialized():
        phase(26, 'a process group of %d ranks was left running: torn down'
              % dist.get_world_size())
        dist.destroy_process_group()
    counts = [1] + ([torch.cuda.device_count()]
                    if torch.cuda.device_count() > 1 else [])
    for n in counts:
        t0 = time.perf_counter()
        errors = entry_points.dryrun_multichip(n)
        seconds['dryrun_multichip(%d)' % n] = time.perf_counter() - t0
        phase(26, 'dryrun_multichip(%d) on %d NCCL rank(s), %dx%dx8 f32: '
              'error / limit %s (fields rtol %g atol %g, aux rtol %g atol '
              '%g)' % (n, n, 8 * n, 4 * n, ', '.join(
                  '%s %.3g (max abs %.3g)' % (name, e['of_limit'],
                                              e['max_abs_err'])
                  for name, e in errors.items()),
                  entry_points.FIELD_TOL['rtol'],
                  entry_points.FIELD_TOL['atol'],
                  entry_points.AUX_TOL['rtol'], entry_points.AUX_TOL['atol']))
    if len(counts) == 1:
        phase(26, 'one card present: dryrun_multichip(n > 1) not run')
    phase(26, 'seconds per call: %s; on %s' % (', '.join(
        '%s %.3f' % kv for kv in seconds.items()), card))
    return launches, checked


def embedding_bag_bwd_call(layout, idx, w, gout, torch):
    """torch.autograd.grad of one F.embedding_bag per band (pre-clipped,
    pre-offset indices, per_sample_weights, mode='sum') with respect to
    its table, for the upstream gradient ``gout``: the library yardstick
    for kernel B's backward, which the port never calls.  Returns (fn,
    check) where check(grad) is the largest difference from the packed
    table gradient ``grad``."""
    F = torch.nn.functional
    flat_g = gout.reshape(-1, layout.width)
    outs, tabs, gs, spans = [], [], [], []
    for ng, ngp, t0, nt, goff, tab0, tablen in layout.bands:
        if nt == 0:
            continue
        term = layout.term_i64[t0:t0 + nt]
        flat = idx[t0:t0 + nt].reshape(nt, -1).long()
        rows = torch.minimum(flat.clamp(min=0), term[:, 1:2] - 1) + (
            (term[:, 0:1] - tab0) // ngp)
        tab = layout.table[tab0:tab0 + tablen].detach().view(
            -1, ngp).clone().requires_grad_(True)
        outs.append(F.embedding_bag(
            rows.T.contiguous(), tab, mode='sum',
            per_sample_weights=w[t0:t0 + nt].reshape(nt, -1).T.contiguous()))
        tabs.append(tab)
        gs.append(F.pad(flat_g[:, goff:goff + ng], (0, ngp - ng)))
        spans.append((tab0, tablen))

    def fn():
        return torch.autograd.grad(outs, tabs, gs, retain_graph=True)

    def check(grad):
        return max(float((g.reshape(-1) - grad[tab0:tab0 + n]).abs().max())
                   for g, (tab0, n) in zip(fn(), spans))

    return fn, check


def kernel_b_bwd_groups(groups, dtype_name, card, torch, seed, label=None):
    """Phase 27 (a) on one set of kernel-B groups {name: (layout, idx,
    w)}: the backward kernel against its plain version within
    BWD_TOL[dtype_name] of max for a seeded upstream gradient, two runs
    against each other, timed beside its bound, the plain version and the
    embedding_bag backward; its lines name the set ``label`` (default
    dtype_name).  Returns the summed record."""
    from climt_tpu_torch.components.rrtmg import fused_mix

    tol = BWD_TOL[dtype_name]
    label = label or dtype_name
    gen = torch.Generator(device='cpu').manual_seed(seed)
    total = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                 bound_ms=0.0, rerun=0.0)
    for gname, (layout, idx, w) in groups.items():
        cells = tuple(idx.shape[1:])
        ncell = idx[0].numel()
        gout = torch.randn(cells + (layout.width,), generator=gen,
                           dtype=w.dtype).to(w.device)
        grad = fused_mix.mix_groups_bwd_cuda(layout, idx, w, gout)
        again = fused_mix.mix_groups_bwd_cuda(layout, idx, w, gout)
        ref = fused_mix.mix_groups_bwd_plain(layout, idx, w, gout)
        lib_fn, lib_check = embedding_bag_bwd_call(layout, idx, w, gout,
                                                   torch)
        torch.cuda.synchronize()
        err, scale = max_rel_err(grad, ref)
        rerun = float((grad - again).abs().max())
        lib_err = lib_check(grad)
        if not err <= tol * scale:
            fail('kernel B backward disagrees on %s (%s): max abs err %g > '
                 '%g * %g' % (gname, dtype_name, err, tol, scale))
        if not lib_err <= tol * scale:
            fail('embedding_bag backward disagrees on %s (%s) by %g'
                 % (gname, dtype_name, lib_err))
        ms = cuda_ms(lambda: fused_mix.mix_groups_bwd_cuda(
            layout, idx, w, gout), 20, torch)
        plain_ms = cuda_ms(lambda: fused_mix.mix_groups_bwd_plain(
            layout, idx, w, gout), 2, torch)
        library_ms = cuda_ms(lib_fn, 10, torch)
        nbytes, ops = group_cost(layout, ncell)
        bound_ms, bound_by = bound(
            nbytes, ops, FP64_OPS_PER_S if w.dtype == torch.float64
            else FP32_OPS_PER_S)
        for key, val in (('ms', ms), ('plain_ms', plain_ms),
                         ('library_ms', library_ms), ('bound_ms', bound_ms)):
            total[key] += val
        total['max_abs_err'] = max(total['max_abs_err'], err)
        total['rerun'] = max(total['rerun'], rerun)
        phase(27, 'kernel B backward %s %s: %d cells, %d bands, %d terms: '
              'max abs err %.3g (max %.3g, limit %g of max), two runs apart '
              'by %.3g; %.4f ms, plain %.4f ms, embedding_bag backward %.4f '
              'ms (apart by %.3g), bound %.4f ms (%s, %.1f MB), %.0f%% of '
              'bound' % (gname, label, ncell, len(layout.bands),
                         layout.nterms, err, scale, tol, rerun, ms, plain_ms,
                         library_ms, lib_err, bound_ms, bound_by,
                         nbytes / 1e6, 100.0 * bound_ms / ms))
        del grad, again, ref, lib_fn, lib_check, gout
    total['share'] = total['bound_ms'] / total['ms']
    total['bound_by'] = 'bytes'
    phase(27, 'kernel B backward %s, %d groups: %.4f ms, plain %.4f ms, '
          'embedding_bag backward %.4f ms, bound %.4f ms, %.0f%% of bound; '
          'on %s' % (label, len(groups), total['ms'], total['plain_ms'],
                     total['library_ms'], total['bound_ms'],
                     100.0 * total['share'], card))
    return total


def calibration_phase(dev, card, counters, init_fn, step_fn):
    """Phase 27: the LW k-table calibration on the card (see the module
    docstring).  Returns the backward kernel's float32 and float64
    records and the launch counts of (b) and (c): kernel B ('B', float64),
    its backward ('bwd') and kernel A ('A')."""
    import numpy as np
    import torch
    from climt_tpu_torch.components.rrtmg import fused_mix
    from climt_tpu_torch.components.rrtmg import lw_spectral as LW
    from climt_tpu_torch import _build
    from climt_tpu_torch.components.rrtmg import lw_surrogate
    from climt_tpu_torch.tools import calibrate_lw_ktables as cal

    t_phase = time.perf_counter()
    bwd = fused_mix.mix_groups_bwd_cuda
    # (a) the backward kernel at the LW groups' shapes of the main paths.
    # The float32 path: the gradient in theta of the T85 chunk's gaseous
    # optical depths and Planck fractions (taumol_lw, as the GCM calls it)
    # from float32 tables built from the calibrated theta, one backward
    # launch for each of the two groups
    cs, wx = chunk_lw_coefs(t85_chunk(step_fn, init_fn, dev))
    theta32 = torch.as_tensor(lw_surrogate.load_calibrated_params(),
                              dtype=torch.float32,
                              device=dev).requires_grad_(True)
    tables32 = lw_surrogate.build_tables(theta32)
    gen = torch.Generator(device='cpu').manual_seed(26)
    bwd.launches = 0
    outs32 = LW.taumol_lw(cs, wx, torch.float32, tables32)
    grad32, = torch.autograd.grad(
        sum((x * torch.randn(x.shape, generator=gen).to(dev)).sum()
            for x in outs32), theta32)
    torch.cuda.synchronize()
    launches_f32 = bwd.launches
    if launches_f32 != 2:
        fail('phase 27: the float32 taumol gradient launched the backward '
             '%d times, not 2' % launches_f32)
    if not (bool(torch.isfinite(grad32).all()) and bool((grad32 != 0).any())):
        fail('phase 27: the float32 taumol gradient in theta is not finite '
             'or is zero')
    phase(27, 'float32 taumol gradient in theta on the T85 chunk (%d '
          'cells): %d backward launches, %d of %d nonzero, max %.3g' % (
              outs32[0].shape[:-1].numel(), launches_f32,
              int((grad32 != 0).sum()), grad32.numel(),
              float(grad32.abs().max())))
    f32_groups = dict(zip(('lw_taug', 'lw_fracs'), (
        g.finish() for g in LW.taumol_lw_terms(cs, wx, torch.float32,
                                               tables32))))
    del outs32, grad32
    f64_groups = {k: v for k, v in example_f64_groups().items()
                  if k in ('lw_taug', 'lw_fracs')}
    # the calibration's own shape: the LW groups of one float64 column
    # (the tropical anchor, nz=30), launched here outside the counted runs
    with torch.no_grad():
        column_groups = {k: v for k, v in captured_groups(
            lambda: cal.flux_fn(cal.tropical_inputs(device=dev), None,
                                cal.FLAGS0), torch.float64).items()
            if k in ('lw_taug', 'lw_fracs')}
    del cs, wx
    regs = ptxas_report(_build.BUILD_INFO['log'], 'mix_groups_bwd_kernel')
    if sorted(regs) != ['float32', 'float64'] or any(
            r[1] or r[2] for r in regs.values()):
        fail('phase 27: the backward kernel spills or is missing from the '
             'ptxas report: %s' % regs)
    phase(27, 'kernel B backward build: %s' % '; '.join(
        '%s %d registers, %d bytes spill stores, %d bytes spill loads'
        % ((dtype,) + tuple(r)) for dtype, r in sorted(regs.items())))
    records = {'float32': kernel_b_bwd_groups(f32_groups, 'float32', card,
                                              torch, seed=27),
               'float64': kernel_b_bwd_groups(f64_groups, 'float64', card,
                                              torch, seed=28)}
    kernel_b_bwd_groups(column_groups, 'float64', card, torch, seed=29,
                        label='float64 one column')
    del column_groups
    records['float32']['launches'] = launches_f32
    del f32_groups, tables32, theta32
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t_phase

    # (b) the loss and its gradient at the prior, card against CPU; the
    # training targets are the port's own CPU fluxes at the calibrated
    # parameters (no reference caches here)
    cpu = torch.device('cpu')
    tables_cal = lw_surrogate.build_tables(
        lw_surrogate.load_calibrated_params())

    def loss_args(device, targets=None):
        train = []
        for i, (family, desc) in enumerate(cal.TRAIN):
            inputs, flags = cal.case_inputs(family, desc, device)
            train.append((inputs, flags, targets[i] if targets else
                          cal.synthetic_targets(inputs, flags, tables_cal)))
        return (train, cal.tropical_inputs(device=device),
                cal.tropical_inputs(co2_scale=2.0, device=device),
                torch.as_tensor(lw_surrogate.default_params(),
                                device=device))

    args_cpu = loss_args(cpu)
    args = loss_args(dev, [t for _, _, t in args_cpu[0]])
    theta0 = lw_surrogate.default_params()
    val_cpu, grad_cpu = cal.value_and_grad(torch.as_tensor(theta0), *args_cpu)
    kernels = dict(counters, bwd=bwd)

    def zero_counts():
        for counter in kernels.values():
            counter.launches = 0

    def counts():
        return {k: c.launches for k, c in kernels.items()}

    zero_counts()
    val, grad = cal.value_and_grad(torch.as_tensor(theta0, device=dev),
                                   *args)
    torch.cuda.synchronize()
    launches = counts()
    n_calls = len(cal.TRAIN) + 2
    if launches != {'A': 0, 'B': 3 * n_calls, 'bwd': 2 * n_calls}:
        fail('phase 27: one loss and gradient launched %s for %d LW calls, '
             'not 3 B, 2 backward and no A each' % (launches, n_calls))
    val_err = abs(float(val) - float(val_cpu))
    grad_err, grad_scale = max_rel_err(grad.cpu(), grad_cpu)
    if not (np.isfinite(float(val)) and bool(torch.isfinite(grad).all())):
        fail('phase 27: non-finite loss or gradient on the card')
    if not val_err <= CALIBRATION_TOL['value'] * abs(float(val_cpu)):
        fail('phase 27: the loss on the card differs from the CPU by %g of '
             '%g' % (val_err, float(val_cpu)))
    if not grad_err <= CALIBRATION_TOL['grad'] * grad_scale:
        fail('phase 27: the gradient on the card differs from the CPU by %g '
             '(max %g)' % (grad_err, grad_scale))
    phase(27, 'calibration loss at the prior, %d training cases + 2 anchors '
          '+ prior, f64: %.10g on the card, %.10g on the CPU (apart by %.3g '
          'of it, limit %g); gradient (%d of %d nonzero) apart by %.3g of '
          'max %.3g (limit %g); launches %s' % (
              len(cal.TRAIN), float(val), float(val_cpu),
              val_err / abs(float(val_cpu)), CALIBRATION_TOL['value'],
              int((grad_cpu != 0).sum()), grad_cpu.numel(),
              grad_err / grad_scale, grad_scale, CALIBRATION_TOL['grad'],
              launches))

    # (c) Adam steps on the card, the tool's step and learning rate
    theta = torch.as_tensor(theta0, device=dev)
    m, v = torch.zeros_like(theta), torch.zeros_like(theta)
    losses, step_s = [], []
    zero_counts()
    for i in range(ADAM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val_i, grad_i = cal.value_and_grad(theta, *args)
        theta, m, v = cal.adam_step(i, theta, m, v, grad_i, 2e-2, 4000)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(val_i))
    steps = counts()
    if steps != {k: n * ADAM_STEPS for k, n in launches.items()}:
        fail('phase 27: %d Adam steps launched %s, not %d times %s'
             % (ADAM_STEPS, steps, ADAM_STEPS, launches))
    for kernel, count in steps.items():
        launches[kernel] += count
    if not (all(np.isfinite(losses)) and bool(torch.isfinite(theta).all())):
        fail('phase 27: non-finite loss or parameters in the Adam steps')
    if not losses[-1] < losses[0]:
        fail('phase 27: %d Adam steps did not lower the loss: %s'
             % (ADAM_STEPS, losses))
    phase(27, '%d Adam steps on the card: %.4f s/step (median %.4f, first '
          '%.4f), loss %.6g -> %.6g; per step kernel B %g, backward %g, '
          'kernel A %g; on %s' % (
              ADAM_STEPS, sum(step_s) / len(step_s), median(step_s),
              step_s[0], losses[0], losses[-1], steps['B'] / ADAM_STEPS,
              steps['bwd'] / ADAM_STEPS, steps['A'] / ADAM_STEPS, card))

    # (d) the loud refusals
    th32 = torch.as_tensor(theta0, dtype=torch.float32, device=dev)
    tables32 = lw_surrogate.build_tables(th32.requires_grad_(True))
    trop32 = {k: x.float() if torch.is_tensor(x) else x
              for k, x in args[1].items()}
    try:
        cal.flux_fn(trop32, tables32, cal.FLAGS0)
        fail('phase 27: a float32 LW call with tables that require grad '
             'did not raise')
    except NotImplementedError as exc:
        if 'kernel A' not in str(exc):
            fail('phase 27: the float32 call raised %r, not at kernel A'
                 % exc)
        refused_a = str(exc)
    layout, idx, w = f64_groups['lw_fracs']
    try:
        fused_mix.mix_groups(layout, idx, w.clone().requires_grad_(True))
        fail('phase 27: kernel B took weights that require grad')
    except NotImplementedError as exc:
        refused_b = str(exc)
    del f64_groups, layout, idx, w, args, tables32, trop32
    torch.cuda.empty_cache()
    phase(27, 'refused: %r; %r' % (refused_a, refused_b))
    phase(27, 'phase 27 in %.1f s ((a) %.1f s); on %s' % (
        time.perf_counter() - t_phase, t_a, card))
    return records, launches


def mesh_cards_phase():
    """Phase 28: the mesh layouts across the machine's cards, one NCCL
    rank per card (tests/torch_helpers.py:card_mesh_rank, the cases of
    tests/test_torch_gpu_mesh.py).  On n >= 2 cards: the m-sharded moist
    GCM with spectral, FV and SL moisture on (n, 1), and on (2, 2) where
    n = 4, and the replicated-spectral layout of the moist GCM in the
    three modes and of Held-Suarez on every layout of
    torch_helpers.card_meshes(n), at 64x32x10 float64 for 7 steps (every
    field within CARD_SMALL_TOL of max of the same model on the rank's
    own card) and at T85 float32 for one refresh step (compare_steps's
    float32 limits); each first step's collectives equal the CPU's,
    each T85 refresh launches the kernels of its column chunks, FV's mass
    is conserved and the water fixer closes (card_mesh_failures).  Then
    T85 float32 s/step on n cards against one card (card_timing): the
    m-sharded model, the replicated layout and the replicated layout with
    shard_lon, with spectral and FV moisture, 12-step windows alternating
    with the one-card model, medians; per step the collectives and the
    bytes handed to them, and from one traced refresh step and one plain
    step the NCCL kernels' share of the device time and the part of it
    that overlaps other kernels.  On one card it prints that it needs 2
    or more and returns None; else {'B', 'A', 'B_f64'}: the kernel
    launches of the counted steps, summed over the ranks."""
    import tempfile

    import torch
    from torch_helpers import CARD_TIMEOUT, spawn_ranks

    n = torch.cuda.device_count()
    if n < 2:
        phase(28, 'the mesh layouts across cards need 2 or more CUDA '
              'cards; this machine has %d, so phase 28 does not run' % n)
        return None
    cards = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    on = ('%d x %s' % (n, cards[0]) if len(set(cards)) == 1
          else ' / '.join(cards))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn_ranks('card_mesh_rank', n, tmp, timeout=CARD_TIMEOUT,
                            device='cuda', timing=True)
        spawn_s = time.perf_counter() - t0
    return mesh_cards_report(ranks, on, spawn_s)


def mesh_cards_report(ranks, on, spawn_s):
    """Phase 28's checks and lines on the ranks' records of
    card_mesh_rank(timing=True) (``on``: the cards, ``spawn_s``: the
    spawn's seconds); returns phase 28's launches."""
    from torch_helpers import (CARD_SMALL_TOL, CARD_WINDOW, card_lon_shape,
                               card_mesh_failures)

    n = len(ranks)
    for what in ('complete', 'answers', 'collectives', 'launches',
                 'conservation'):
        failures = card_mesh_failures(ranks, n, what)
        if failures:
            fail('phase 28 %s, %d failures:\n  %s' % (
                what, len(failures), '\n  '.join(failures[:30])))
    cases = sorted(key for key in ranks[0] if isinstance(key, tuple))
    launches = {'B': 0, 'A': 0, 'B_f64': 0}
    for recs in ranks:
        for key in cases:
            b, a = recs[key]['counts']['launches']
            if key[0] == 'small':
                launches['B_f64'] += b
            else:
                launches['B'] += b
                launches['A'] += a
    for size, layout, mesh_name in sorted({key[:3] for key in cases}):
        parts = []
        for key in [k for k in cases if k[:3] == (size, layout, mesh_name)]:
            worst = max(ranks, key=lambda recs: recs[key]['err'])[key]
            rec = ranks[0][key]
            parts.append('%s %.3g (%s), collectives %s, launches %s' % (
                key[3], worst['err'], worst['field'],
                rec['counts']['collectives'], rec['counts']['launches']))
        measure = ('largest difference of max, limit %g' % CARD_SMALL_TOL
                   if size == 'small' else
                   "largest share of compare_steps's float32 limit")
        phase(28, '%s %s %s on %d NCCL ranks against one card (%s): %s; '
              'on %s' % (size, layout, mesh_name, n, measure,
                         '; '.join(parts), on))
    phase(28, 'phase 28 on %d cards in %.1f s (the spawn, the builds, the '
          'cases and the timed windows); '
          'collectives as (all_to_all transposes, halo calls, all_reduce, '
          'all_gather) of the first step of rank 0, kernel launches as '
          '(B, A) of that step, a radiation refresh' % (n, spawn_s))
    for mode, (err, field) in ranks[0]['own_step'].items():
        init = [recs[key]['init_err'] for recs in ranks for key in cases
                if key[:2] == ('t85', 'm_sharded') and key[3] == mode]
        phase(28, 'T85 f32 %r, why the m-sharded model starts from the '
              "one-card carry: its own initial carry is within %.3g of "
              "compare_steps's limits of the one-card one (every rank and "
              'mesh, held to 1), but its step from there reaches %.3g of '
              'them (%s; rank 0, not held: the float32 refresh is not '
              'continuous at roundoff); on %s' % (mode, max(init), err,
                                                  field, on))
    for mode, recs in ranks[0]['timing'].items():
        one = median(recs['one card']['s'])
        parts = ['one card %.4f' % one]
        for kind in ('m_sharded', 'replicated', 'replicated_lon'):
            medians = [median(r['timing'][mode][kind]['s']) for r in ranks]
            parts.append('%s %.4f (slowest rank %.4f, %.2fx one card)' % (
                kind, medians[0], max(medians), max(medians) / one))
        phase(28, 'T85 f32 %r, %d-step windows, median s/step of rank 0: '
              '%s; the lon layout on mesh %s; on %s' % (
                  mode, CARD_WINDOW, ', '.join(parts), card_lon_shape(n),
                  on))
        for kind in ('m_sharded', 'replicated', 'replicated_lon'):
            rec = recs[kind]
            steps = len(rec['s'])
            calls = ' '.join('%g' % (c / steps)
                             for c in rec['counts']['collectives'])
            mbytes = ' '.join('%.3f' % (b / steps / 1e6)
                              for b in rec['counts']['bytes'])
            shares = []
            for label in ('refresh', 'plain'):
                tr = [r['timing'][mode][kind][label] for r in ranks]
                share = [t['nccl_s'] / t['kernel_s'] if t['kernel_s']
                         else 0.0 for t in tr]
                overlap = [t['overlap_s'] / t['nccl_s'] if t['nccl_s']
                           else 0.0 for t in tr]
                shares.append(
                    '%s step: NCCL %.4f of %.4f s of device time (share '
                    '%.3f, ranks %.3f-%.3f), %d of %d launches, overlapping '
                    'other kernels %.3f of it (ranks up to %.3f), traced '
                    'wall %.4f s' % (
                        label, tr[0]['nccl_s'], tr[0]['kernel_s'], share[0],
                        min(share), max(share), tr[0]['nccl_launches'],
                        tr[0]['launches'], overlap[0], max(overlap),
                        tr[0]['wall']))
            phase(28, 'T85 f32 %r %s, rank 0 per step: collectives %s '
                  '(transposes, halo, all_reduce, all_gather), MB handed '
                  'to them %s; %s; on %s' % (
                      mode, kind, calls, mbytes, '; '.join(shares), on))
        one = recs['one card']
        phase(28, 'T85 f32 %r one card (rank 0): refresh step %.4f s of '
              'device time in %d launches, plain step %.4f s in %d; on %s'
              % (mode, one['refresh']['kernel_s'],
                 one['refresh']['launches'], one['plain']['kernel_s'],
                 one['plain']['launches'], on))
    return launches


def check_close(a, b, tol, label):
    """max of |a - b| / (atol + rtol |b|), failing above 1."""
    import numpy as np
    ratio = float(np.max(np.abs(a - b) / (tol['atol'] + tol['rtol']
                                          * np.abs(b))))
    if not ratio <= 1.0:
        fail('%s: differs by %.3g of its limit' % (label, ratio))
    return ratio


def convection_inputs(size, dtype, calls, dev):
    """The emanuel_convect arguments of the moist GCM's convection calls
    whose 0-based indices are ``calls`` (call n steps from the state after
    n steps), from its seed-0 start."""
    import torch
    from climt_tpu_torch.dycore import moist_gcm

    real = moist_gcm.emanuel_convect
    captured, count = {}, [0]

    def spy(*args):
        if count[0] in calls:
            captured[count[0]] = tuple(
                a.clone() if torch.is_tensor(a) else a for a in args)
        count[0] += 1
        return real(*args)

    moist_gcm.emanuel_convect = spy
    try:
        _, init_fn, _, run_fn = moist_gcm.build_moist_gcm(
            dtype=dtype, device=dev, **size)
        run_fn(init_fn(0), max(calls) + 1)
    finally:
        moist_gcm.emanuel_convect = real
    return [captured[n] for n in calls]


def convection_case(label, args, card, torch):
    """Phase 29 for one call: the kernel against the plain version."""
    from climt_tpu_torch.components import emanuel_convection as E

    T = args[0]
    ncol, nz = T.shape
    dtype = str(T.dtype).replace('torch.', '')
    before = E.emanuel_convect_cuda.launches
    out = E.emanuel_convect(*args)
    torch.cuda.synchronize()
    if E.emanuel_convect_cuda.launches != before + 1:
        fail('%s: emanuel_convect made %d kernel launches, not 1' % (
            label, E.emanuel_convect_cuda.launches - before))
    n_dev = device_launches(lambda: E.emanuel_convect(*args), torch)
    if n_dev != 1:
        fail('%s: emanuel_convect made %d device operations, not 1' % (
            label, n_dev))
    ref = E.emanuel_convect_plain(*args)
    active = int((ref['iflag'] > 0).sum())
    with_flux = int((ref['cbmf'] != 0).sum())
    if active == 0 or with_flux == 0:
        fail('%s: %d columns convect and %d have a cloud-base mass flux: '
             'the check has no teeth' % (label, active, with_flux))
    flips = int((out['iflag'] != ref['iflag']).sum())
    if flips > 0.001 * ncol:
        fail('%s: iflag differs on %d of %d columns' % (label, flips, ncol))
    same = torch.ones(ncol, dtype=torch.bool, device=T.device)
    errs, worst = {}, 0.0
    for key in ('ft', 'fq', 'fu', 'fv', 'precip', 'wd', 'tprime', 'qprime',
                'cbmf', 'cape'):
        a, b = out[key], ref[key]
        if not bool(torch.isfinite(a).all()):
            fail('%s: non-finite %s' % (label, key))
        err, scale = max_rel_err(a, b)
        rel = err / scale if scale > 0 else err
        errs[key] = rel
        worst = max(worst, rel)
        eq = a == b
        same &= eq.all(dim=1) if eq.dim() == 2 else eq
        if not rel <= CONVECTION_TOL[dtype]:
            fail('%s: %s differs by %.3g of its largest value %.3g > %g'
                 % (label, key, rel, scale, CONVECTION_TOL[dtype]))
    ms = cuda_median_ms(lambda: E.emanuel_convect(*args), 20, torch)
    plain_ms = cuda_median_ms(lambda: E.emanuel_convect_plain(*args), 5,
                              torch)
    size = T.element_size()
    # in: T, q, qs, u, v, p, ph and cbmf; out: the four tendencies, six
    # column values and the int64 iflag
    nbytes = ncol * ((7 * nz + 2) * size + (4 * nz + 6) * size + 8)
    cost = EMANUEL_OPS
    ops = (ncol * (cost['level'] * nz + cost['column'])
           + active * (cost['active_level'] * nz + cost['cell'] * nz * nz
                       + cost['upper_cell'] * nz * (nz - 1) // 2
                       + cost['active_column']))
    bound_ms, bound_by = bound(nbytes, ops, FP32_OPS_PER_S if dtype ==
                               'float32' else FP64_OPS_PER_S)
    phase(29, '%s (%d x %d %s): %d convecting, iflag differs on %d '
          'columns, %d of %d columns bit for bit; largest error of max: %s;'
          ' kernel %.4f ms (bound %.4f ms by %s, %.0f%%), plain %.2f ms; '
          'on %s' % (label, ncol, nz, dtype, active, flips,
                     int(same.sum()), ncol, ', '.join(
                         '%s %.2g' % kv for kv in errs.items()),
                     ms, bound_ms, bound_by, 100.0 * bound_ms / ms,
                     plain_ms, card))
    return dict(max_rel_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def convection_phase(dev, card):
    """Phase 29: the convection kernel on the T85 GCM's columns (float32)
    and on the 32x16x10 float64 GCM's; returns the kernel lines' records
    (the T85 call last, the main path's shape)."""
    import torch

    small = dict(nlon=32, nlat=16, nz=10, rad_col_chunk=128)
    recs = {}
    for n, args in zip((0, 6), convection_inputs(small, torch.float64,
                                                  (0, 6), dev)):
        recs['float64'] = convection_case(
            '32x16x10 after %d steps' % n, args, card, torch)
    for n, args in zip((6, 36), convection_inputs(T85, torch.float32,
                                                  (6, 36), dev)):
        recs['float32'] = convection_case(
            'T85 after %d steps' % n, args, card, torch)
    torch.cuda.empty_cache()
    return recs


def term_writer_bytes(plan, nz, ncol, itemsize):
    """Bytes the term-writer kernel needs for one call on (nz, ncol): each
    of the plan's fields read once (floats in the working type, ints 4
    bytes, the troposphere mask 1), each term's weight written and its
    index where its part has more than one row; the solar source's terms
    once a column."""
    ncell = nz * ncol
    nbytes = ncell * (itemsize * len(plan.fields) + 4 * len(plan.int_fields)
                      + 1)
    for g, parts in enumerate(plan.parts):
        cells = ncol if g in plan.columns else ncell
        for _, table, n in parts:
            many = len(table.shape) == 2 and table.shape[0] > 1
            nbytes += cells * n * (itemsize + (4 if many else 0))
    return nbytes


def host_ms(fn, reps, torch):
    """Host milliseconds a call of fn() (its launches enqueued, the card
    not waited for), over reps calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def term_writer_phase(dev, card):
    """Phase 30: the term-writer kernel (csrc/taumol_terms.cu) alone, float32,
    at rrtmg_l60's call (60 x 32768) and at a T85 chunk (28 x 8192) of
    torch_helpers.taumol_columns: each LW and SW call against its plain
    version (term_writer.taumol_terms_plain) on the CPU (indices and weights
    equal, the power terms within TERM_POWER_EPS), one launch a call, its
    device ms (back-to-back calls under CUDA events) beside its byte bound,
    its host ms a call, and the plain version's ms on the card.  Returns the
    kernel line's record at the T85 chunk, LW and SW summed."""
    import torch
    from climt_tpu_torch.components.rrtmg import lw_spectral as LW
    from climt_tpu_torch.components.rrtmg import sw_spectral as SW
    from climt_tpu_torch.components.rrtmg import term_writer as TW
    from torch_helpers import taumol_coefs, taumol_columns, term_writer_check

    f32 = torch.float32
    solar = SW.solar_variability(-1, 0.0)[:6]
    rec = None
    for nz, ncol in ((60, 32768), (28, 8192)):     # 28 last: the main path
        total = dict(max_abs_err=0.0, ms=0.0, host_ms=0.0, plain_ms=0.0,
                     bound_ms=0.0, library_ms=None)
        for call in ('lw', 'sw'):
            before = TW.taumol_terms_cuda.launches
            report = term_writer_check(call, f32, nz, ncol, dev)
            launched = TW.taumol_terms_cuda.launches - before
            if launched != 1:
                fail('term writer %s %dx%d: %d launches, not one' % (
                    call, nz, ncol, launched))
            for name, r in report.items():
                if (r['idx_mismatch'] or r['max_ulp']
                        or r['power_eps'] > TERM_POWER_EPS):
                    fail('term writer %s %dx%d: %s differs from its plain '
                         'version: %s' % (call, nz, ncol, name, r))
                total['max_abs_err'] = max(total['max_abs_err'],
                                           r['max_abs_err'])
                phase(30, 'term writer %s %dx%d f32 %s: %d terms equal to its '
                      'plain version on the CPU but the power terms, within '
                      '%d ulps (%.2f eps, limit %d; %s), largest weight '
                      'difference %.3g' % (
                          call, nz, ncol, name, r['terms'],
                          r['power_max_ulp'], r['power_eps'], TERM_POWER_EPS,
                          ', '.join(r['power_terms']) or 'none differ',
                          r['max_abs_err']))
            torch.cuda.empty_cache()
        cs, wx, css = taumol_coefs(taumol_columns(nz, ncol), f32, dev)
        plans = dict(lw=LW.lw_term_plan(LW.load_kdist(), tuple(sorted(wx))),
                     sw=SW.sw_term_plan('ref'))
        runs = dict(lw=lambda: LW.taumol_lw_terms(cs, wx, f32),
                    sw=lambda: SW.taumol_sw_terms(css, -1, *solar, f32))
        for call, run in runs.items():
            ms = cuda_ms(run, 20, torch, queued=True)
            h_ms = host_ms(run, 20, torch)
            # the same call with its terms written by the plain version
            kernel_route, TW.taumol_terms = (TW.taumol_terms,
                                             TW.taumol_terms_plain)
            try:
                p_ms = cuda_ms(run, 3, torch)
            finally:
                TW.taumol_terms = kernel_route
            nbytes = term_writer_bytes(plans[call], nz, ncol, 4)
            b_ms, _ = bound(nbytes, 0)
            phase(30, 'term writer %s %dx%d f32: %.4f ms device, %.4f ms '
                  'host a call; bound %.4f ms (bytes, %.1f MB), %.0f%% of '
                  'bound; plain version %.3f ms a call; on %s' % (
                      call, nz, ncol, ms, h_ms, b_ms, nbytes / 1e6,
                      100.0 * b_ms / ms, p_ms, card))
            for key, val in (('ms', ms), ('host_ms', h_ms),
                             ('plain_ms', p_ms), ('bound_ms', b_ms)):
                total[key] += val
        total.update(bound_by='bytes', share=total['bound_ms'] / total['ms'],
                     shape=[nz, ncol])
        del cs, wx, css, runs
        torch.cuda.empty_cache()
        rec = total
    return rec


def max_rel_err(a, b):
    """max |a - b| and the scale max |b| of two tensors."""
    return float((a - b).abs().max()), float(b.abs().max())


def main():
    import numpy as np
    import torch

    t_start = time.perf_counter()
    # ---- phase 1: device ---------------------------------------------
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this needs a CUDA GPU')
    if not os.path.isdir(os.path.join(HERE, 'climt_tpu_torch')):
        fail('climt_tpu_torch/ is not beside chip_smoke.py')
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, 'tests'))
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    phase(1, 'card: %s' % card)
    print(card, flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        fail('TF32 matmul is on; the SHT needs full float32 matmuls')
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda:0')
    f32 = torch.float32

    from climt_tpu_torch import _build
    from climt_tpu_torch.components import emanuel_convection as E
    from climt_tpu_torch.components.rrtmg import fused_mix, rtrn_kernel
    from climt_tpu_torch.components.rrtmg import lw_spectral as LW
    from climt_tpu_torch.components.rrtmg import sw_spectral as SW
    from climt_tpu_torch.components.rrtmg import term_writer as TW
    from climt_tpu_torch.convert import carry_to_numpy
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm

    # ---- phase 2: build ----------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    phase(2, 'kernels built in %.1f s (nvcc %.1f s) -> %s' % (
        time.perf_counter() - t0, _build.BUILD_INFO['seconds'],
        os.path.relpath(_build.BUILD_INFO['path'], HERE)))
    for line in _build.BUILD_INFO['log'].splitlines():
        if 'registers' in line or 'spill' in line:
            print('    ptxas: ' + line.strip(), flush=True)

    rng = torch.Generator(device='cpu').manual_seed(0)
    report = {}

    # ---- phase 3: kernel B -------------------------------------------
    R, ng, T, S = 1175, 16, 8, (28, 8192)
    table = torch.rand(R, ng, generator=rng).to(dev)
    idx = torch.randint(-3, R + 3, (T,) + S, generator=rng,
                        dtype=torch.int32).to(dev)   # some clip at both ends
    w = torch.randn((T,) + S, generator=rng).to(dev)
    out = fused_mix.mix_rows_cuda(table, idx, w)
    ref = fused_mix.mix_rows_plain(table, idx.long(), w)
    torch.cuda.synchronize()
    err, scale = max_rel_err(out, ref)
    if not err <= 1e-6 * scale:
        fail('kernel B disagrees: max abs err %g > 1e-6 * %g' % (err, scale))
    ms = cuda_ms(lambda: fused_mix.mix_rows_cuda(table, idx, w), 20, torch)
    phase(3, 'kernel B one table R=%d ng=%d T=%d S=%s: max abs err %.3g '
          '(max %.3g), %.4f ms' % (R, ng, T, S, err, scale, ms))
    del table, idx, w, out, ref

    # the six groups of one T85 radiation chunk, from the initial state
    dycore, init_fn, step_fn, _ = build_moist_gcm(
        dtype=f32, device=dev, **T85)
    model = step_fn.__self__
    chunk = t85_chunk(step_fn, init_fn, dev)
    play, plev, tlay, tlev, tsfc, h2o, o3, co2, o2, emis = chunk
    cs, wx = chunk_lw_coefs(chunk)
    css = SW.gas_coefs_sw(play, plev, tlay, h2o, o3, co2,
                          torch.zeros_like(play), torch.zeros_like(play), o2,
                          G, AVOGADRO)
    groups = dict(zip(
        ('lw_planck', 'lw_taug', 'lw_fracs', 'sw_taug', 'sw_taur',
         'sw_sflux'),
        (LW.planck_terms(tlay, tlev, tsfc),)
        + LW.taumol_lw_terms(cs, wx, f32)
        + SW.taumol_sw_terms(css, -1, *model.solar_config[:6], f32)))
    del chunk, cs, css
    report['B'] = kernel_b_groups(
        {name: group.finish() for name, group in groups.items()}, 1e-6,
        card, torch)
    del groups
    torch.cuda.empty_cache()

    # the six float64 groups of the full-radiation example's first call
    # at 128x62x28, captured as the components run them; float64 sums in
    # another order than the plain version's: a few ulps
    report['B_f64'] = kernel_b_groups(example_f64_groups(), 1e-12, card,
                                      torch)
    torch.cuda.empty_cache()

    # ---- phase 4: kernel A -------------------------------------------
    sup = LW.support_tensors(f32, dev)
    rec_6 = LW._support_scalar('rec_6')
    ngb = torch.as_tensor(rtrn_kernel.NGB, device=dev)
    dwave_g = (sup['delwave'][ngb] * LW._support_scalar('wtdiff')
               * (3.141592653589793 * 2.0e4))

    def rtrn_inputs(nz, ncol):
        def r(*shape):
            return torch.rand(*shape, generator=rng).to(dev)
        cld = r(nz, ncol)
        return (r(nz, ncol, 140) * 2.0, r(nz, ncol, 140),
                r(nz, ncol, 16) * 0.2, r(nz + 1, ncol, 16) * 0.2,
                r(ncol, 16) * 0.2, 0.9 + 0.1 * r(16, ncol),
                1.5 + 0.3 * r(16, ncol), (cld > 0.5) * r(nz, ncol),
                r(nz, ncol, 16) * 3.0, dwave_g)

    report['A'] = dict(library_ms=None)
    for nz in (60, 28):       # 28 last: the main path's shape
        rec = kernel_a_check(rtrn_inputs(nz, 8192) + (rec_6,), 2e-6, card,
                             torch, n=4)
        rec['max_abs_err'] = max(rec['max_abs_err'],
                                 report['A'].get('max_abs_err', 0.0))
        report['A'].update(rec)
    torch.cuda.empty_cache()

    # ---- phase 30: the term writer alone -------------------------------
    report['terms'] = term_writer_phase(dev, card)

    # ---- phase 5: small model, GPU vs CPU ------------------------------
    small = dict(nlon=32, nlat=16, nz=10, rad_every=6, rad_col_chunk=128,
                 dtype=f32)
    finals = {}
    for where in ('cpu', 'cuda'):
        _, small_init, _, small_run = build_moist_gcm(device=where, **small)
        carry, _ = small_run(small_init(0), 7)
        finals[where] = carry_to_numpy(carry)[2]
    diffs = {}
    for key, tol in SMALL_TOL.items():
        a, b = finals['cuda'][key], finals['cpu'][key]
        if not np.isfinite(a).all():
            fail('phase 5: non-finite %s on the GPU' % key)
        diffs[key] = float(np.abs(a - b).max())
        if not diffs[key] <= tol:
            fail('phase 5: %s differs by %g > %g' % (key, diffs[key], tol))
    phase(5, '32x16x10 f32, 7 steps, GPU vs CPU max abs diff: %s' % (
        ', '.join('%s %.3g' % kv for kv in diffs.items())))

    # ---- phase 6: T85 moist GCM through the entry point ----------------
    # (the model built by build_moist_gcm in phase 3)
    carry = init_fn(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_mix.mix_groups_cuda.launches = 0
    rtrn_kernel.rtrn_lw_cuda.launches = 0
    E.emanuel_convect_cuda.launches = 0
    TW.taumol_terms_cuda.launches = 0
    step_s = []
    diag = None
    for _ in range(T85_STEPS):
        t0 = time.perf_counter()
        carry, diag = step_fn(carry, None)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = {'B': fused_mix.mix_groups_cuda.launches,
                'A': rtrn_kernel.rtrn_lw_cuda.launches,
                'convection': E.emanuel_convect_cuda.launches,
                'terms': TW.taumol_terms_cuda.launches}
    refreshes = sum(1 for k in range(T85_STEPS) if k % T85['rad_every'] == 0)
    chunks = 256 * 128 // T85['rad_col_chunk']
    if launches['terms'] != 2 * chunks * refreshes:
        fail('T85: the term writer launched %d times in %d radiation '
             'refreshes of %d chunks (not 2 a chunk)' % (
                 launches['terms'], refreshes, chunks))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    T_grid = dycore.sht.synthesize(carry[1]['T'])
    for key, val in [('T', T_grid)] + list(diag.items()):
        if not bool(torch.isfinite(val).all()):
            fail('T85: NaN or inf in %s' % key)
    if not (T_grid.shape == (28, 128, 256)
            and 150.0 < float(T_grid.min()) and float(T_grid.max()) < 350.0):
        fail('T85: temperature out of range [%g, %g]' % (
            float(T_grid.min()), float(T_grid.max())))
    if not (launches['A'] > 0 and launches['B'] > 0):
        fail('T85 run did not go through both kernels: %s' % launches)
    if launches['convection'] != T85_STEPS:
        fail('T85: the convection kernel launched %d times in %d steps, '
             'not once a step' % (launches['convection'], T85_STEPS))
    if launches['B'] > B_LAUNCHES_PER_REFRESH_MAX * refreshes:
        fail('T85: kernel B launched %d times in %d radiation refreshes, '
             'more than %d each' % (launches['B'], refreshes,
                                    B_LAUNCHES_PER_REFRESH_MAX))
    # 12 steps hold 2 radiation refreshes (steps 0 and 6): the mean over
    # all of them is the model's cost at its 1-in-6 radiation cadence
    rad_steps = [s for i, s in enumerate(step_s) if i % 6 == 0]
    other = [s for i, s in enumerate(step_s) if i % 6 != 0]
    mean_s = sum(step_s) / len(step_s)
    gps = 256 * 128 * 28 / mean_s
    phase6_s = mean_s
    phase(6, 'T85 %d steps on %s: step s %s' % (
        T85_STEPS, card, ' '.join('%.4f' % s for s in step_s)))
    phase(6, 'T85: %.4f s/step, %.4g gridpoint-steps/s; radiation steps '
          '%s s, others %.4f s; peak memory %.2f GB; launches A=%d B=%d '
          'convection=%d term writer=%d; T in [%.1f, %.1f] K; on %s' % (
              mean_s, gps, ' '.join('%.4f' % s for s in rad_steps),
              sum(other) / len(other), peak_gb, launches['A'],
              launches['B'], launches['convection'], launches['terms'],
              float(T_grid.min()), float(T_grid.max()), card))

    # breakdown of one radiation step (outside the counted run)
    prev, now, grids, aux, k = carry
    t_ph = time.perf_counter()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cols = model._to_cols
    T_c = cols(grids['T'])
    q_c = torch.clamp(cols(grids['q']), min=0.0)
    ph_c = cols(grids['p_half'])
    pm_c = 0.5 * (ph_c[1:] + ph_c[:-1])
    _, rad_s = timed(lambda: model.radiation(
        T_c, q_c, pm_c, ph_c, aux['Ts'].reshape(-1),
        torch.tensor(0.0, device=dev)))
    (phys, _, _), phys_s = timed(lambda: model.physics(grids, aux, 1))
    _, dyn_s = timed(lambda: model._fix_water(
        model.dycore.step(prev, now, phys=phys)[1], prev, phys))
    phase(6, 'T85 breakdown: radiation %.4f s, physics without radiation '
          '%.4f s, dynamics + water fixer %.4f s (%.1f s to measure)' % (
              rad_s, phys_s, dyn_s, time.perf_counter() - t_ph))
    phase(6, 'T85: kernel B launches per radiation refresh %g (limit %d), '
          'kernel A %g; radiation alone %.4f s per refresh; on %s' % (
              launches['B'] / refreshes, B_LAUNCHES_PER_REFRESH_MAX,
              launches['A'] / refreshes, rad_s, card))
    del carry, model, grids, aux, prev, now, phys
    torch.cuda.empty_cache()

    # ---- phase 29: the convection kernel on phase 6's model's columns --
    convection_recs = convection_phase(dev, card)

    # ---- phase 7: standalone radiation ---------------------------------
    nz, ncol = 60, 8192
    p_sfc = 1013.0
    plev1 = np.linspace(p_sfc, 0.3, nz + 1)
    play1 = 0.5 * (plev1[:-1] + plev1[1:])
    tlay1 = np.maximum(300.0 - 60.0 * (1 - play1 / p_sfc) / 0.8, 205.0)
    tlev1 = np.concatenate([[302.0], 0.5 * (tlay1[:-1] + tlay1[1:]),
                            [tlay1[-1]]])

    def cols_of(x):
        return torch.as_tensor(np.repeat(np.asarray(x)[:, None], ncol, 1),
                               dtype=f32, device=dev)

    play, plev = cols_of(play1), cols_of(plev1)
    tlay, tlev = cols_of(tlay1), cols_of(tlev1)
    tsfc = torch.full((ncol,), 300.0, dtype=f32, device=dev)
    h2o = cols_of(0.016 * (play1 / p_sfc) ** 3)
    o3 = cols_of(5e-6 * np.exp(-0.5 * ((np.log(play1) - np.log(20.0))
                                       / 1.2) ** 2))
    co2 = torch.full_like(play, 355e-6)
    o2 = torch.full_like(play, 0.21)
    zero = torch.zeros_like(play)
    emis = torch.ones((16, ncol), dtype=f32, device=dev)
    mu0 = torch.full((ncol,), 0.6, dtype=f32, device=dev)
    alb = torch.full((ncol,), 0.2, dtype=f32, device=dev)
    solar = SW.solar_variability(-1, 0.0)
    z16 = torch.zeros((nz, ncol, 16), dtype=f32, device=dev)
    z14 = torch.zeros((nz, ncol, 14), dtype=f32, device=dev)

    def rad():
        lw = LW.rrtmg_lw_fluxes(
            play, plev, tlay, tlev, tsfc, h2o, o3, co2, zero, zero, o2,
            zero, zero, zero, zero, emis, zero, z16, zero, zero,
            torch.full_like(play, 25.0), torch.full_like(play, 10.0), z16,
            9.80665, 6.022140857e23, 1004.64, use_tables=False)
        sw = SW.rrtmg_sw_fluxes(
            play, plev, tlay, h2o, o3, co2, zero, zero, o2, alb, alb, alb,
            alb, mu0, zero, (z14,) * 4, (z14,) * 3, 1.0, -1, 0.0, -1, solar,
            9.80665, 6.022140857e23, 1004.64, icld=0, use_tables=False)
        return lw[2] + sw[4]

    hr = rad()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(hr).all()):
        fail('standalone radiation: non-finite heating rate')
    t0 = time.perf_counter()
    for _ in range(3):
        hr = rad()
    torch.cuda.synchronize()
    rad_cols = ncol / ((time.perf_counter() - t0) / 3)
    phase(7, 'standalone LW+SW radiation nz=%d ncol=%d: %.4g columns/s '
          'on %s' % (nz, ncol, rad_cols, card))

    # ---- phases 8-12: Held-Suarez, fused and on the component API, and
    # the full-radiation GCM on the component API -----------------------
    counters = {'A': rtrn_kernel.rtrn_lw_cuda,
                'B': fused_mix.mix_groups_cuda}

    def launch_counts():
        return 'kernel launches A=%d B=%d' % (counters['A'].launches,
                                              counters['B'].launches)

    for run_phase in (held_suarez_model_phase, climatology_phase,
                      component_api_phase):
        for counter in counters.values():
            counter.launches = 0
        run_phase(dev, card, launch_counts)
    launches_f64, _ = radiation_example_phase(11, FULL_RADIATION, dev, card,
                                              counters)
    torch.cuda.empty_cache()
    full_radiation_card_vs_cpu_phase(dev, card, launch_counts)

    # ---- phases 13-15: the insolation GCM, the DCMIP and grey examples,
    # the land-surface stack -----------------------------------------------
    launches_insolation = insolation_phase(dev, card, counters)
    for kernel, count in launches_insolation.items():
        launches_f64[kernel] += count
    torch.cuda.empty_cache()
    examples_phase(dev, card)
    torch.cuda.empty_cache()
    land_surface_phase(dev, card)
    torch.cuda.empty_cache()

    # ---- phases 16-19: grid-space transport, the moist GCM with FV and SL
    # moisture, registered tracers, the remaining examples and the IO ----
    transport_phase(dev, card)
    for kernel, count in grid_moisture_phase(dev, card, counters).items():
        launches[kernel] += count
    torch.cuda.empty_cache()
    tracer_phase(dev, card)
    for kernel, count in examples_io_phase(dev, card, counters).items():
        launches_f64[kernel] += count
    torch.cuda.empty_cache()

    # ---- phase 20: the moist GCM over a torch.distributed mesh ---------
    for kernel, count in mesh_world_of_one_phase(dev, card, counters,
                                                 phase6_s).items():
        launches[kernel] += count
    torch.cuda.empty_cache()
    mesh_shared_card_phase(dev, card)

    # ---- phase 21: the replicated-spectral layout ----------------------
    for kernel, count in layout_world_of_one_phase(dev, card,
                                                   counters).items():
        launches[kernel] += count
    torch.cuda.empty_cache()
    layout_shared_card_phase(dev, card)

    # ---- phase 22: examples printing card fields ------------------------
    verbose_examples_phase(card)

    # ---- phases 23-24: CORK longwave radiation, the matmul zonal DFT ----
    cork_phase(dev, card, counters)
    torch.cuda.empty_cache()
    matmul_dft_phase(dev, card, counters, init_fn, step_fn)
    torch.cuda.empty_cache()

    # ---- phase 25: installed LW k-tables through kernel B -------------
    for kernel, count in ktables_phase(dev, card, counters, init_fn,
                                       step_fn, report).items():
        launches[kernel] += count

    # ---- phase 26: the repository's entry points on the port ----------
    torch.cuda.empty_cache()
    entry_launches, checked = entry_points_phase(dev, card, counters)
    for kernel, count in entry_launches.items():
        launches[kernel] += count
        report[kernel]['max_abs_err'] = max(report[kernel]['max_abs_err'],
                                            checked[kernel]['max_abs_err'])

    # ---- phase 27: the LW k-table calibration on the card ---------------
    torch.cuda.empty_cache()
    bwd_report, calib_launches = calibration_phase(dev, card, counters,
                                                   init_fn, step_fn)
    launches_f64['B'] += calib_launches['B']

    # ---- phase 28: the mesh layouts across cards (2 or more) -----------
    torch.cuda.empty_cache()
    mesh_launches = mesh_cards_phase()
    if mesh_launches is not None:
        launches['B'] += mesh_launches['B']
        launches['A'] += mesh_launches['A']
        launches_f64['B'] += mesh_launches['B_f64']

    # the float32 entries count the T85 runs of phases 6, 17, 20, 21 and
    # 25, the flagship step of phase 26 and, on 2 or more cards, the
    # counted T85 steps of phase 28's ranks (phase 24 checks its own: 24 B
    # and 4 A launches per refresh); the float64 entry of kernel B counts
    # phase 28's 64x32x10 steps there too
    kernels = [
        dict(name='mix_groups_cuda', route='cuda',
             source='climt_tpu_torch/csrc/mix_rows.cu',
             replaces='climt_tpu/components/rrtmg/fused_mix.py:76',
             launches=launches['B'], **report['B']),
        dict(name='rtrn_lw_cuda', route='cuda',
             source='climt_tpu_torch/csrc/rtrn_lw.cu',
             replaces='climt_tpu/components/rrtmg/pallas_rtrn.py:195',
             launches=launches['A'], **report['A']),
        # the float64 instantiation of kernel B: the RRTMG components on
        # the full-radiation examples (phases 11 and 13) and on the
        # examples of phase 19
        dict(name='mix_groups_cuda[float64]', route='cuda',
             source='climt_tpu_torch/csrc/mix_rows.cu',
             replaces='climt_tpu/components/rrtmg/fused_mix.py:76',
             launches=launches_f64['B'], **report['B_f64']),
        # kernel B's backward: in float64 the calibration's loss and Adam
        # steps of phase 27, in float32 the taumol gradient of phase 27
        # (a); JAX differentiates the gather of interp.mix_rows with XLA
        # there
        dict(name='mix_groups_bwd_cuda[float64]', route='cuda',
             source='climt_tpu_torch/csrc/mix_rows_bwd.cu',
             replaces='climt_tpu/components/rrtmg/interp.py:45',
             launches=calib_launches['bwd'],
             **{k: bwd_report['float64'][k] for k in (
                 'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                 'library_ms')}),
        dict(name='mix_groups_bwd_cuda[float32]', route='cuda',
             source='climt_tpu_torch/csrc/mix_rows_bwd.cu',
             replaces='climt_tpu/components/rrtmg/interp.py:45',
             **{k: bwd_report['float32'][k] for k in (
                 'launches', 'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                 'bound_by', 'library_ms')}),
        # the term writer: phase 6's counted T85 steps, timed and checked at
        # a T85 chunk (LW and SW summed, the largest weight difference of
        # either) in phase 30
        dict(name='taumol_terms_cuda', route='cuda',
             source='climt_tpu_torch/csrc/taumol_terms.cu', replaces=None,
             **dict(report['terms'], launches=launches['terms'])),
        # the convection kernel: phase 6's counted T85 steps (float32), with
        # phase 29's float64 record beside its float32 one
        dict(name='emanuel_convect_cuda', route='cuda',
             source='climt_tpu_torch/csrc/emanuel.cu', replaces=None,
             launches=launches['convection'], **convection_recs['float32'],
             float64=convection_recs['float64']),
    ]
    print('chip_smoke: all phases in %.1f s, the nvcc build included'
          % (time.perf_counter() - t_start), flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
