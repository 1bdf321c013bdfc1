"""The mesh: an ordered list of torch devices, one per shard.

Counterpart of ``velox_tpu/parallel/mesh.py``. Role parity: the
reference's Task::start driver topology (velox/exec/Task.h:166-172),
where the execution resources of a query are the shards of one data axis
``d``; exchanges between them are explicit tensor movement
(parallel/exchange.py).

``DistributedTask`` is a single controller, as the reference's is: one
Python process drives every shard. The reference's mesh is a
``jax.sharding.Mesh`` of (often virtual) devices; here shard i is placed
on ``cuda:(i % device_count)``, so on one card every shard shares
``cuda:0`` (the analogue of the reference's virtual CPU mesh), and on a
host with more cards the same code spreads them. ``make_mesh(n, "cpu")``
puts every shard on the host, which is what the CPU tests use.

The reference's ``shard_leading`` and ``replicated`` are
``NamedSharding`` specs for stacked (n, cap) batches; shards here are
separate batches on their own devices, so they have no counterpart.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

DATA_AXIS = "d"


class Mesh:
    """Shard i runs on ``devices[i]``, along the one data axis."""

    axis = DATA_AXIS

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> List[torch.device]:
        """Each device once, in shard order."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self):
        return f"Mesh({self.size} shards on {self.distinct_devices()})"


def make_mesh(n: Optional[int] = None, device: str = "cuda") -> Mesh:
    """A mesh of ``n`` shards: on CUDA (the default) shard i is on
    ``cuda:(i % device_count)`` and ``n`` defaults to the card count; on
    ``"cpu"`` every shard is on the host and ``n`` defaults to 1. Raises
    when CUDA is asked for and absent."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; ask for "
                               "device='cpu' to place the shards on the host")
        count = torch.cuda.device_count()
        n = n or count
        return Mesh([torch.device("cuda", i % count) for i in range(n)])
    if kind != "cpu":
        raise ValueError(f"make_mesh: unsupported device {device!r}")
    return Mesh([torch.device("cpu")] * (n or 1))
