"""Run one cell of the climt_tpu_torch benchmark on this machine's cards.

    python3 gcmbench/run.py --workload <name> --seed <n> --seconds <s>
                            --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (``harness.result_line``); the numbers compared with the plain
reference are the last lines of standard error.  Exits with 2, and
prints no result, without the CUDA cards the cell asks for.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # one process with few threads: BLAS and OpenMP pools of one thread,
    # set before torch and numpy load, so that set-up (imports, tables)
    # does not contend with the host's other work for every core
    for var in ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS',
                'MKL_NUM_THREADS'):
        os.environ[var] = '1'
    # the program chooses its LW k-tables from this variable first; the
    # reference reads the files in the checkout, so both read the same
    os.environ.pop('CLIMT_TPU_LW_KTABLES', None)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from gcmbench import harness
    return harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), T_START)


if __name__ == '__main__':
    sys.exit(main())
