"""Process-group start-up for multi-GPU runs
(climt_tpu/parallel/distributed.py).

One process drives one device.  ``initialize_distributed`` starts the
``torch.distributed`` default process group: NCCL on CUDA cards, gloo
only when the caller asks for ``device='cpu'``.  A typical run on N cards
of one host:

    torchrun --nproc_per_node=N my_model.py

where ``my_model.py`` does

    from climt_tpu_torch.parallel import initialize_distributed, make_mesh
    initialize_distributed()            # reads torchrun's RANK etc.
    mesh = make_mesh()                  # (lat, lon) over the N ranks
    build_moist_gcm(..., mesh=mesh)

``torchrun`` describes the cluster in the environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``); without
it, pass ``coordinator_address``, ``num_processes`` and ``process_id``.
``spawn_ranks`` starts the processes itself: one per card, or gloo ranks
on the CPU.
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# every process group's timeout: a rank that raises leaves the others
# blocked in a collective until it expires
TIMEOUT = datetime.timedelta(minutes=5)
_CLUSTER_ENV = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR')


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None,
                           device='cuda'):
    """Start the default process group (idempotent); returns the world
    size.

    ``coordinator_address``: ``host:port`` of rank 0's TCP store, or an
    init-method URL (``tcp://...``, ``file:///path``), with
    ``num_processes`` (the world size) and ``process_id`` (this rank).
    Without it the cluster is read from the environment (``torchrun``).
    When nothing describes a cluster (no argument and none of ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` set) the run is single-process: this
    logs so and returns 1.  A described cluster that fails to start
    raises.

    ``device='cuda'`` takes NCCL and first binds the process to its card:
    ``local_device_ids[0]``, else ``LOCAL_RANK``, else the rank modulo
    the host's card count.  Without NCCL it raises; it never falls back
    to gloo, which serves ``device='cpu'`` only."""
    if dist.is_initialized():
        return dist.get_world_size()
    if coordinator_address is None and not any(
            k in os.environ for k in _CLUSTER_ENV):
        logger.info('initialize_distributed: no cluster is described (no '
                    'coordinator_address, none of %s set); running '
                    'single-process', ', '.join(_CLUSTER_ENV))
        return 1
    kind = torch.device(device).type
    if kind == 'cuda':
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise RuntimeError(
                "initialize_distributed(device='cuda') needs CUDA and NCCL "
                '(cuda available: %s, nccl available: %s); pass '
                "device='cpu' for gloo on the CPU"
                % (torch.cuda.is_available(), dist.is_nccl_available()))
        backend = 'nccl'
    elif kind == 'cpu':
        backend = 'gloo'
    else:
        raise ValueError('device %r: expected cuda or cpu' % (device,))
    kwargs = {}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError('coordinator_address needs num_processes and '
                             'process_id')
        url = coordinator_address
        if '://' not in url:
            url = 'tcp://' + url
        kwargs = dict(init_method=url, world_size=int(num_processes),
                      rank=int(process_id))
    if backend == 'nccl':
        if local_device_ids is not None:
            local = int(local_device_ids[0])
        elif 'LOCAL_RANK' in os.environ:
            local = int(os.environ['LOCAL_RANK'])
        else:
            rank = kwargs.get('rank', int(os.environ.get('RANK', 0)))
            local = rank % torch.cuda.device_count()
        torch.cuda.set_device(local)
    dist.init_process_group(backend, timeout=TIMEOUT, **kwargs)
    return dist.get_world_size()


def process_info():
    """(rank, world size, local devices, global devices): one device per
    process, so the global device count is the world size."""
    if not dist.is_initialized():
        return 0, 1, 1, 1
    world = dist.get_world_size()
    return dist.get_rank(), world, 1, world


def spawn_ranks(target, world, kwargs=None, device='cuda', timeout=600.0,
                out_dir=None):
    """Run ``target(rank, world, **kwargs)`` in ``world`` spawned
    processes of one process group; returns each rank's result.

    ``target`` is a module-level callable (the spawned processes import
    it by name).  ``device='cuda'`` (the default) gives NCCL ranks, rank
    r on card r, and raises before starting any rank when the machine
    has fewer than ``world`` cards; ``'cpu'`` gives gloo ranks of one
    thread each.  The ranks meet through a FileStore file in ``out_dir``
    (a temporary directory when None), and the inputs and results go
    through pickle files there.  Joins with ``timeout`` seconds and kills
    every rank still alive then; a rank that fails or is killed raises
    here, with its traceback."""
    device = torch.device(device).type
    if device not in ('cuda', 'cpu'):
        raise ValueError('device %r: expected cuda or cpu' % (device,))
    if device == 'cuda' and torch.cuda.device_count() < world:
        raise RuntimeError(
            "spawn_ranks(world=%d, device='cuda') needs %d CUDA cards, one "
            "per rank; this machine has %d (pass device='cpu' for gloo "
            'ranks on the CPU)' % (world, world, torch.cuda.device_count()))
    if out_dir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return spawn_ranks(target, world, kwargs, device, timeout, tmp)
    out_dir = str(out_dir)
    # the inputs go through a file: a start-up message larger than a pipe
    # buffer would make each start wait for the previous rank's imports
    with open(os.path.join(out_dir, 'inputs.pkl'), 'wb') as f:
        pickle.dump(kwargs or {}, f)
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, world, target, device, out_dir))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
    for p in procs:
        p.join(10.0)
    errors = []
    for rank, p in enumerate(procs):
        err = os.path.join(out_dir, 'rank%d.err' % rank)
        if os.path.exists(err):
            with open(err) as f:
                errors.append('rank %d:\n%s' % (rank, f.read()))
        elif p.exitcode != 0:
            errors.append('rank %d: exit code %s%s' % (
                rank, p.exitcode, ' (killed after %g s)' % timeout
                if rank in hung else ''))
    if errors:
        raise RuntimeError('%s on %d %s ranks failed:\n%s' % (
            getattr(target, '__name__', target), world, device,
            '\n'.join(errors)))
    results = []
    for rank in range(world):
        with open(os.path.join(out_dir, 'rank%d.pkl' % rank), 'rb') as f:
            results.append(pickle.load(f))
    return results


def _rank_main(rank, world, target, device, out_dir):
    """One spawned rank: join the group, run the target on the inputs of
    ``spawn_ranks``, write its result (or its traceback), leave the
    group."""
    try:
        if device == 'cpu':
            torch.set_num_threads(1)     # the ranks share the host's cores
        with open(os.path.join(out_dir, 'inputs.pkl'), 'rb') as f:
            kwargs = pickle.load(f)
        initialize_distributed(
            'file://' + os.path.join(out_dir, 'store'), world, rank,
            local_device_ids=[rank] if device == 'cuda' else None,
            device=device)
        result = target(rank, world, **kwargs)
        with open(os.path.join(out_dir, 'rank%d.pkl' % rank), 'wb') as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, 'rank%d.err' % rank), 'w') as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
