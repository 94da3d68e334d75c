"""Kernel B's backward on one GPU: the design in
``climt_tpu_torch/csrc/mix_rows_bwd.cu`` against an older source of the
kernel and against ablations of its own.

    python bwd_designs.py [--baseline OLD.cu] [--rounds 2]
    python bwd_designs.py --adam-steps 20 [--tree DIR]

Each design is a copy of a kernel source built by nvcc into its own
library under ``climt_tpu_torch/_build/designs/``.  ``--baseline`` names
a source with the C interface of commit 2ff23a1 (bands, nband, terms,
idx, w, ncell, width, gout, max_tablen, dtable, stream), for example
``git show 2ff23a1:climt_tpu_torch/csrc/mix_rows_bwd.cu``.  The ablation
``nostage`` is this tree's kernel with the upstream gradient's global
reads removed (the copies only zero-fill): it gives wrong answers and
shows what those reads cost.  The ablation ``runs_first`` swaps the
grid's order: every run of a band goes out before the next band, where
the kernel sends the blocks of every band of one run together.

The inputs are the kernel's shapes on the main paths, made as
``chip_smoke.py`` makes them: the LW taug and fracs groups of the T85
radiation chunk (float32, tables built from the calibrated parameters),
of the full-radiation example's first call (float64) and of one
calibration column (the tropical anchor, float64), with a seeded upstream
gradient.  For each group it prints the rows' statistics (how often
neighbouring cells change row, distinct rows per 32 and 128 cells), each
design's error against the plain backward, and the CUDA-event ms of every
design, in rounds of alternating order; then each design's registers and
spills (ptxas) and the atomic instructions of its SASS (cuobjdump).

With ``--adam-steps N`` it times N Adam steps of the LW k-table
calibration on the card instead, as ``chip_smoke.py`` phase 27 (c) takes
them (the tool's four cases with the port's CPU fluxes at the calibrated
parameters as targets, the two anchors and the prior), with the package
of the checkout ``--tree`` (default: this one): run it from two
checkouts in alternating order to compare them.  Runs only on a machine
with a card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def design_sources(baseline=None):
    """{name: kernel source}: this tree's, the ablation, the baseline."""
    from climt_tpu_torch import _build
    with open(os.path.join(_build.CSRC, 'mix_rows_bwd.cu')) as f:
        new = f.read()

    edits = {'nostage': [('const bool ok = g_ok && it * 8 < left;',
                          'const bool ok = false;')],
             'runs_first': [('gridDim.y + blockIdx.y',
                             'gridDim.x + blockIdx.x'),
                            ('load_band(bands, blockIdx.x)',
                             'load_band(bands, blockIdx.y)'),
                            ('grid(nband, static_cast<unsigned>(ry),',
                             'grid(static_cast<unsigned>(ry), nband,')]}
    sources = {'new': new}
    for name, pairs in edits.items():
        text = new
        for old, repl in pairs:
            if text.count(old) != 1:
                raise ValueError('the kernel source no longer has %r once'
                                 % old)
            text = text.replace(old, repl)
        sources[name] = text
    if baseline:
        with open(baseline) as f:
            sources['baseline'] = f.read()
    return sources


def build(sources):
    """{name: (ctypes library, library path, ptxas log)}, one nvcc each,
    all started together."""
    from climt_tpu_torch import _build
    out_dir = os.path.join(_build.BUILD_ROOT, 'designs')
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        src = os.path.join(out_dir, name + '.cu')
        with open(src, 'w') as f:
            f.write(text)
        so = os.path.join(out_dir, name + '.so')
        cmd = [_build._nvcc()] + _build.NVCC_FLAGS + ['-shared', '-o', so, src]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed on %s:\n%s' % (name, err[-3000:]))
        lib = ctypes.CDLL(so)
        for suffix in ('f32', 'f64'):
            getattr(lib, 'climt_mix_groups_bwd_' + suffix).restype = _I
        libs[name] = (lib, so, out + err)
    return libs


def sass_atomics(so):
    """{(type, opcode): count} of the atomic instructions of the backward
    kernels in a library's SASS."""
    from climt_tpu_torch import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), 'cuobjdump')
    text = subprocess.run([cuobjdump, '-sass', so], capture_output=True,
                          text=True).stdout
    counts, dtype = {}, None
    for line in text.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            dtype = (None if 'bwd_kernel' not in m.group(1) else
                     'float32' if 'IfE' in m.group(1) else 'float64')
            continue
        m = re.search(r'/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)',
                      line)
        if dtype and m and re.match(r'(ATOM|RED|CAS)', m.group(1)):
            key = (dtype, m.group(1))
            counts[key] = counts.get(key, 0) + 1
    return counts


def launch(lib, name, layout, idx, w, gout):
    """The gradient of the packed table by one design."""
    from climt_tpu_torch import _build
    grad = torch.zeros(layout.table.shape, dtype=w.dtype, device=w.device)
    fn = getattr(lib, 'climt_mix_groups_bwd_' + (
        'f32' if w.dtype == torch.float32 else 'f64'))
    args = [_P(layout.band_desc.data_ptr()), _I(len(layout.bands)),
            _P(layout.term_desc.data_ptr()), _P(idx.data_ptr()),
            _P(w.data_ptr()), _L(idx[0].numel()), _I(layout.width),
            _P(gout.data_ptr())]
    if name == 'baseline':
        args.append(_I(max(b[6] for b in layout.bands)))
    rc = fn(*args, _P(grad.data_ptr()),
            _P(torch.cuda.current_stream().cuda_stream))
    _build.check_launch(rc, name)
    return grad


def row_stats(layout, idx):
    """How often neighbouring cells change row, and the distinct rows per
    32 and per 128 cells, over the terms of more than one row."""
    change, per32, per128 = [], [], []
    for t, (_, rows) in enumerate(layout.terms):
        if rows == 1:
            continue
        r = idx[t].reshape(-1).long().clamp(0, rows - 1)
        change.append(float((r[1:] != r[:-1]).float().mean())
                      if r.numel() > 1 else 0.0)
        for win, acc in ((32, per32), (128, per128)):
            n = r.numel() // win * win
            if n:
                s = r[:n].reshape(-1, win).sort(dim=1).values
                acc.append(float(((s[:, 1:] != s[:, :-1]).sum(1) + 1)
                                 .float().mean()))
    mean = (lambda x, d: float(np.mean(x)) if x else d)
    return mean(change, 0.0), mean(per32, 1.0), mean(per128, 1.0)


def main_path_groups(dev):
    """{set: {group: (layout, idx, w)}} at the main paths' shapes."""
    from climt_tpu_torch.components.rrtmg import lw_spectral as LW
    from climt_tpu_torch.components.rrtmg import lw_surrogate
    from climt_tpu_torch.dycore.moist_gcm import build_moist_gcm
    from climt_tpu_torch.tools import calibrate_lw_ktables as cal

    _, init_fn, step_fn, _ = build_moist_gcm(dtype=torch.float32,
                                             device=dev, **cs.T85)
    coefs, wx = cs.chunk_lw_coefs(cs.t85_chunk(step_fn, init_fn, dev))
    tables = lw_surrogate.build_tables(torch.as_tensor(
        lw_surrogate.load_calibrated_params(), dtype=torch.float32,
        device=dev))
    lw = ('lw_taug', 'lw_fracs')
    sets = {'float32 T85 chunk': dict(zip(lw, (
        g.finish() for g in LW.taumol_lw_terms(coefs, wx, torch.float32,
                                               tables))))}
    del init_fn, step_fn, coefs, wx
    sets['float64 example call'] = {
        k: v for k, v in cs.example_f64_groups().items() if k in lw}
    with torch.no_grad():
        sets['float64 one column'] = {k: v for k, v in cs.captured_groups(
            lambda: cal.flux_fn(cal.tropical_inputs(device=dev), None,
                                cal.FLAGS0), torch.float64).items()
            if k in lw}
    return sets


def adam_seconds(steps, dev):
    """Seconds of each of ``steps`` Adam steps of the calibration on the
    card, each step synchronized at both ends, as phase 27 (c) takes
    them; and the loss before and after."""
    import time
    from climt_tpu_torch.components.rrtmg import lw_surrogate
    from climt_tpu_torch.tools import calibrate_lw_ktables as cal

    tables = lw_surrogate.build_tables(lw_surrogate.load_calibrated_params())
    train = []
    for family, desc in cal.TRAIN:
        inputs, flags = cal.case_inputs(family, desc, 'cpu')
        tgt = cal.synthetic_targets(inputs, flags, tables)
        train.append((cal.case_inputs(family, desc, dev)[0], flags, tgt))
    args = (train, cal.tropical_inputs(device=dev),
            cal.tropical_inputs(co2_scale=2.0, device=dev),
            torch.as_tensor(lw_surrogate.default_params(), device=dev))
    theta = torch.as_tensor(lw_surrogate.default_params(), device=dev)
    m, v = torch.zeros_like(theta), torch.zeros_like(theta)
    seconds, losses = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val, grad = cal.value_and_grad(theta, *args)
        theta, m, v = cal.adam_step(i, theta, m, v, grad, 2e-2, 4000)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(val))
    return seconds, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--baseline', help='a kernel source with the C '
                    'interface of commit 2ff23a1 (max_tablen)')
    ap.add_argument('--rounds', type=int, default=2)
    ap.add_argument('--adam-steps', type=int, default=0,
                    help='time this many calibration Adam steps instead')
    ap.add_argument('--tree', help='the checkout whose climt_tpu_torch '
                    'the Adam steps use (default: this one)')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('bwd_designs needs a CUDA GPU')
    sys.path.insert(0, os.path.abspath(args.tree or cs.HERE))
    sys.path.insert(1, os.path.join(cs.HERE, 'tests'))
    dev = torch.device('cuda:0')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True,
        text=True).stdout.strip()
    print('card: %s; torch %s, CUDA %s' % (card, torch.__version__,
                                           torch.version.cuda), flush=True)
    if args.adam_steps:
        import climt_tpu_torch
        seconds, losses = adam_seconds(args.adam_steps, dev)
        print('%d Adam steps with %s: %.4f s/step (median %.4f, first '
              '%.4f, after it %.4f), loss %.6g -> %.6g' % (
                  len(seconds), os.path.dirname(climt_tpu_torch.__file__),
                  np.mean(seconds), np.median(seconds), seconds[0],
                  np.mean(seconds[1:]), losses[0], losses[-1]))
        return
    from climt_tpu_torch.components.rrtmg import fused_mix
    libs = build(design_sources(args.baseline))
    designs = list(libs)
    sets = main_path_groups(dev)
    gen = torch.Generator(device='cpu').manual_seed(13)
    times = {}
    for sname, groups in sets.items():
        for gname, (layout, idx, w) in groups.items():
            ncell = idx[0].numel()
            nbytes, _ = cs.group_cost(layout, ncell)
            print('%s %s: %d cells, %d terms; rows change between '
                  'neighbouring cells %.4f of the time, distinct rows per 32 '
                  'cells %.3f, per 128 %.3f; byte bound %.4f ms' % (
                      (sname, gname, ncell, layout.nterms)
                      + row_stats(layout, idx)
                      + (nbytes / cs.HBM_BYTES_PER_S * 1e3,)),
                  flush=True)
            gout = torch.randn(tuple(idx.shape[1:]) + (layout.width,),
                               generator=gen, dtype=w.dtype).to(dev)
            ref = fused_mix.mix_groups_bwd_plain(layout, idx, w, gout)

            def run(design):
                return launch(libs[design][0], design, layout, idx, w, gout)

            for design in designs:
                err = float((run(design) - ref).abs().max())
                print('  %s: max abs err %.3g of max' % (
                    design, err / float(ref.abs().max())), flush=True)
            for r in range(args.rounds):
                for design in (designs if r % 2 == 0 else designs[::-1]):
                    times.setdefault((sname, design), []).append(
                        cs.cuda_ms(lambda: run(design), 20, torch))
            del gout, ref
    print('ms per call of both groups, %d rounds in alternating order; on %s'
          % (args.rounds, card))
    for (sname, dname), ms in times.items():
        n = len(sets[sname])
        print('  %-22s %-14s %s' % (sname, dname, ' '.join(
            '%.4f' % sum(ms[i::args.rounds][:n]) for i in range(args.rounds))))
    for name, (_, so, log) in libs.items():
        for dtype, row in sorted(cs.ptxas_report(
                log, 'mix_groups_bwd_kernel').items()):
            print('  ptxas %s %s: %d registers, %d bytes spill stores, %d '
                  'bytes spill loads' % ((name, dtype) + tuple(row)))
        for (dtype, op), n in sorted(sass_atomics(so).items()):
            print('  sass %s %s: %s x%d' % (name, dtype, op, n))


if __name__ == '__main__':
    main()
