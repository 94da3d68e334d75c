"""Tracing and profiling hooks (climt_tpu/utils/profiling.py):
``phase`` names a span, ``trace`` records a Chrome trace of a region,
``StepTimer`` times step loops."""

from __future__ import annotations

import contextlib
import os
import time

import torch


# what ``phase`` returns while no profiler runs: one shared no-op
_NO_SPAN = contextlib.nullcontext()


def phase(name):
    """A named span (``torch.profiler.record_function``) while a
    ``torch.profiler`` profile is active: it shows up in ``trace``'s
    Chrome trace and in the profile's host events, on the device trace's
    clock.  Otherwise a shared no-op context, so an untraced step pays one
    flag check a span.  A span launches no kernel, makes no tensor and
    never synchronizes.

    The program's spans (span: where; layer):

    - ``climt.step``: ``MoistGCM.step``, its whole body; model step
    - ``climt.physics``: ``MoistGCM.physics``; column physics
    - ``climt.convection``: its ``emanuel_convect`` call; column physics
    - ``climt.radiation``: ``MoistGCM.radiation``, refresh steps only,
      inside ``climt.physics``; radiation
    - ``climt.gas_optics``: ``gas_coefs_lw`` + ``taumol_lw`` in
      ``rrtmg_lw_fluxes``, ``gas_coefs_sw`` + ``taumol_sw`` in
      ``rrtmg_sw_fluxes`` (kernel B's launches); gas optics
    - ``climt.lw_sweep``: ``rtrn_lw`` in ``rrtmg_lw_fluxes`` (kernel A);
      LW flux sweep
    - ``climt.sw_solver``: ``spcvrt_sw``/``spcvmc_sw`` in
      ``rrtmg_sw_fluxes``; SW solver
    - ``climt.dynamics``: ``dycore.step`` in ``MoistGCM.step``; dynamics
    - ``climt.transport``: ``FVAdvection.advect``, ``SLAdvection.advect``;
      transport
    - ``climt.fixer``: ``MoistGCM._fix_water``; dynamics
    - ``climt.collective``: ``dist_sht.transpose``, ``halo.LatHalo``,
      ``rep_sht.all_reduce_sum``, ``rep_sht.all_gather_cat``; collectives
    """
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed region (the CPU, and the card when CUDA is
    available) and write ``<logdir>/trace.json``, a Chrome trace that
    chrome://tracing and Perfetto open.  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


def _sync():
    """Wait for the card's queued work, when this process uses CUDA."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Wall-clock timer for step loops.  When the process uses CUDA it
    synchronizes the card at enter and exit, so a step's time includes
    its kernels; otherwise it times the host work (on the card without a
    sync that would be only the launches).

    >>> timer = StepTimer()
    >>> for _ in range(n):
    ...     with timer:
    ...         step()
    >>> timer.mean_seconds
    """

    def __init__(self):
        self.times = []

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def mean_seconds(self):
        return sum(self.times) / max(len(self.times), 1)

    @property
    def total_seconds(self):
        return sum(self.times)
