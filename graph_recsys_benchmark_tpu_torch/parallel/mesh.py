"""The world of ranks that the parallel layer runs over.

Port of the JAX package's ``parallel/mesh.py``.  The JAX mesh is an array
of devices with a data axis ``dp`` and a model axis ``mp``; here a rank is
one process of a ``torch.distributed`` world, and the mesh is that world
seen as ``dp x mp`` ranks in the JAX layout ``devices.reshape(dp, mp)``:
rank = d * mp + m.  The ``mp`` axis row-shards the embedding table (the
``dp`` mode's all-gather and reduce-scatter, parallel/spmd.py); the ``dp``
axis splits the batch, and carries the edge mode's all-reduce and the
``a2a`` mode's all-to-all (parallel/collectives.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

AXES = ("dp", "mp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp x mp`` ranks; this process is `rank` (= d * mp + m), its
    tensors live on `device`.  Collectives over the whole world run over
    `group` (None: the default world); over one axis, over that axis's
    group of this rank: `dp_group` holds the ranks of this rank's m,
    `mp_group` those of its d (parallel/multihost.make_pod_mesh creates
    them).  An axis that spans the world takes `group`; an axis of one
    rank makes no collective call."""

    dp: int
    mp: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Any = None
    dp_group: Any = None
    mp_group: Any = None

    def __post_init__(self):
        if self.dp < 1 or self.mp < 1:
            raise ValueError(f"dp {self.dp} x mp {self.mp}: each axis needs a rank")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of {self.size}")

    @property
    def shape(self):
        return {"dp": self.dp, "mp": self.mp}

    @property
    def size(self):
        return self.dp * self.mp

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on `axis`: d = rank // mp, m = rank % mp."""
        return self.rank // self.mp if axis == "dp" else self.rank % self.mp

    def axis_group(self, axis: str):
        """The process group of this rank's line along `axis`, ordered by
        that axis's coordinate."""
        if axis not in AXES:
            raise ValueError(f"axis {axis!r}: expected one of {AXES}")
        if self.axis_size(axis) == self.size:
            return self.group
        group = self.dp_group if axis == "dp" else self.mp_group
        if group is None:
            raise ValueError(f"a {self.dp} x {self.mp} mesh without its {axis} groups: build "
                             "it with parallel/multihost.make_pod_mesh")
        return group
