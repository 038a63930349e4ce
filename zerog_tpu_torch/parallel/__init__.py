"""Mesh proving in one process: the counterpart of ``zerog_tpu.parallel``."""

from .mesh import make_mesh, shard_axis, AXIS, Mesh, mesh_key
from .sharded_msm import (
    sharded_msm_device, ShardedWindowTable, msm_fixed_sharded,
)
from .sharded_ntt import FourStepNtt
from .sharded_domain import ShardedDomain

__all__ = [
    "make_mesh", "shard_axis", "AXIS", "Mesh", "mesh_key", "sharded_msm_device",
    "ShardedWindowTable", "msm_fixed_sharded", "FourStepNtt", "ShardedDomain",
]
