"""Settings of the benchmark's own tests: run them from the root of the
checkout with

    python -m pytest -p no:cacheprovider gcmbench/tests

The tests marked ``gpu`` need a CUDA card and skip themselves elsewhere.
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# the small CPU runs here are faster on a few threads than on every core
torch.set_num_threads(min(4, torch.get_num_threads()))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: needs a CUDA GPU; the test skips itself where '
        'there is none')
