"""Which torch.distributed calls the gloo backend takes with CUDA tensors,
on two ranks sharing the first card (NCCL refuses two ranks on one GPU).

    python tests/gloo_cuda_probe.py

Each rank prints each call's outcome as it goes: all_reduce, all_gather
and all_to_all_single, the collectives of the distributed transform and
the water fixer, then batch_isend_irecv, the latitude halo's exchange.
A refusal there may abort the rank process, so it runs last.  Needs a
CUDA card; imports neither jax nor climt_tpu.
"""

import datetime
import multiprocessing as mp
import os
import tempfile


def rank_main(rank, store):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method='file://' + store,
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    x = torch.arange(8, dtype=torch.float64, device='cuda:0') + rank

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            outcome = 'ok'
        except RuntimeError as err:
            outcome = '%s: %s' % (type(err).__name__,
                                  str(err).splitlines()[0][:300])
        print('gloo+cuda rank %d %s: %s' % (rank, name, outcome), flush=True)

    def exchange():
        send, recv = x.clone(), torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, send, 1 - rank),
               dist.P2POp(dist.irecv, recv, 1 - rank)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    attempt('all_reduce', lambda: dist.all_reduce(x.clone()))
    attempt('all_gather', lambda: dist.all_gather(
        [torch.empty_like(x) for _ in range(2)], x))
    for dtype in (torch.float64, torch.float32):
        attempt('all_to_all_single %s' % dtype, lambda: dist.all_to_all_single(
            torch.empty_like(x.to(dtype)), x.to(dtype)))
    print('gloo+cuda rank %d: batch_isend_irecv next (a crash here is the '
          'refusal)' % rank, flush=True)
    attempt('batch_isend_irecv', exchange)
    dist.destroy_process_group()


def main():
    ctx = mp.get_context('spawn')
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, 'store')
        procs = [ctx.Process(target=rank_main, args=(r, store))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
        for rank, p in enumerate(procs):
            if p.is_alive():
                p.kill()
                p.join()
            print('rank %d exit code %s' % (rank, p.exitcode), flush=True)


if __name__ == '__main__':
    main()
