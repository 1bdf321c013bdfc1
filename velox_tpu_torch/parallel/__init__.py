"""Distributed execution over a mesh of shards (parallel/mesh.py,
parallel/exchange.py, parallel/distributed.py)."""

from velox_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from velox_tpu_torch.parallel.distributed import DistributedTask  # noqa: F401
