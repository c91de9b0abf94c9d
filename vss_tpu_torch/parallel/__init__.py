"""Multi-slot layer: shard slots and sharded indexes.

Reproduces `vss_tpu/parallel/__init__.py`.
"""
from vss_tpu_torch.parallel import multihost
from vss_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh, make_mesh
from vss_tpu_torch.parallel.sharded import ShardedHNSWIndex

__all__ = ["make_mesh", "Mesh", "SHARD_AXIS", "ShardedHNSWIndex", "multihost"]
