"""The world of ranks that the edge-parallel layer runs over.

Port of the JAX package's ``parallel/mesh.py``.  The JAX mesh is an array
of devices with a data axis ``dp`` and a model axis ``mp``; here a rank is
one process of a ``torch.distributed`` world, and the mesh is that world
seen as ``dp x mp`` ranks.  Only ``mp == 1`` runs: the model axis
row-shards the embedding table (the JAX package's ``dp`` and ``a2a``
modes), which needs all-gather, reduce-scatter and all-to-all, and waits
for ``ROW_SHARDED_ITEM``.  Edge mode needs one collective, the all-reduce
(``parallel/collectives.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

# ROADMAP Queue 1 item by title: the row-sharded table (the JAX package's
# 'dp' and 'a2a' modes and --mesh_mp)
ROW_SHARDED_ITEM = 'ROADMAP Queue 1, "Row-sharded embedding table"'


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp x mp`` ranks; this process is `rank`, its tensors live on
    `device`, and collectives run over `group` (None: the default world).
    A mesh of one rank makes no collective call."""

    dp: int
    mp: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Any = None

    def __post_init__(self):
        if self.mp != 1:
            raise NotImplementedError(
                f"mp {self.mp}: the row-sharded embedding table is not ported: "
                f"{ROW_SHARDED_ITEM}")
        if not 0 <= self.rank < self.dp:
            raise ValueError(f"rank {self.rank} outside a mesh of {self.dp}")

    @property
    def shape(self):
        return {"dp": self.dp, "mp": self.mp}

    @property
    def size(self):
        return self.dp * self.mp

