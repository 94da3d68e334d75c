"""Materialize the surrogate RRTMG-LW k-distribution npz on the port
(tools/build_lw_surrogate_ktables.py).

Builds ``climt_tpu/data/rrtmg_lw_kdist_surrogate.npz`` (the file the JAX
package and the port read) from the calibrated parameter vector
(``climt_tpu/data/rrtmg_lw_surrogate_params.json``, written by
``calibrate_lw_ktables``; the physical priors if absent) through
``components/rrtmg/lw_surrogate.build_tables``.

Run:  python -m climt_tpu_torch.tools.build_lw_surrogate_ktables
(on the CUDA card; ``main(device='cpu')`` runs on the CPU).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import data
from ..components.rrtmg import lw_surrogate
from ..core.util import resolve_device

OUT = os.path.join(data.DATA_DIR, data.LW_KDIST)


def main(device='cuda'):
    theta = torch.as_tensor(lw_surrogate.load_calibrated_params(),
                            device=resolve_device(device))
    with torch.no_grad():
        tables = lw_surrogate.build_tables(theta)
    np.savez_compressed(OUT, **{k: v.cpu().numpy().astype(np.float64)
                                for k, v in tables.items()})
    print('wrote %s (%.2f MB, %d arrays)'
          % (OUT, os.path.getsize(OUT) / 1e6, len(tables)))


if __name__ == '__main__':
    main()
