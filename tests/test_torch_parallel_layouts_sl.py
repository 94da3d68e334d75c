"""The moist GCM with moisture_advection='sl' in the replicated-spectral
layout of parallel.shard_model_state, on the meshes of
torch_helpers.LAYOUTS (lat-only (4, 1) and (2, 2), latitude x longitude
(2, 2) and (1, 4) with shard_lon=True): 2 steps, the radiation refreshed
every 1 (tests/torch_layout_cases.py)."""

from torch_layout_cases import moist_layout_tests

globals().update(moist_layout_tests('sl', steps=2, rad_every=1))
