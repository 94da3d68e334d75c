"""Parallel layer: device meshes, sharding layouts, the distributed
spectral transforms (m-sharded and replicated), the latitude halo and
process-group start-up (climt_tpu/parallel/__init__.py)."""

from .dist_sht import DistributedSHT
from .distributed import initialize_distributed, process_info, spawn_ranks
from .halo import make_lat_halo
from .mesh import grid_sharding, make_mesh, replicated, shard_model_state
from .rep_sht import ReplicatedSHT

__all__ = [
    'DistributedSHT', 'initialize_distributed', 'process_info',
    'spawn_ranks', 'grid_sharding', 'make_mesh', 'replicated',
    'shard_model_state']
