"""Route switches of the flash-GAT pass (ops/flash_gat.FlashGAT).

The JAX package reads module globals of its ``ops/config.py`` at trace
time: ``FLASH_SOFTMAX_SHIFT`` picks the forward's softmax shift,
``FLASH_BWD_GLUE`` (with its 13 MiB fused-table gate) and
``FLASH_BWD_MEGA`` pick the backward.  The port passes the same choice
explicitly, as it passes ``transport``: ``PEATrainer(...,
flash_mode=FlashGATMode(...))`` carries it through the model's forward to
``FlashGAT``.  There is no global state and no environment variable.
"""

from __future__ import annotations

import dataclasses

SOFTMAX_SHIFTS = ("bound", "online")
BACKWARDS = ("fused", "glue", "onepass")


@dataclasses.dataclass(frozen=True)
class FlashGATMode:
    """softmax_shift:
      'bound'  -> the precomputed per-row bound m̂ = leaky(a_dst + max a_src)
                  (K1/K12; the JAX default);
      'online' -> the exact row max m (K12-online: a row-max pass, then the
                  edge walk), exact for any logit spread, where the bound
                  underflows a row whose best logit sits ~80 below m̂.
    bwd:
      'fused'   -> K2, the src scatter fused into the glue kernel (the JAX
                   default);
      'glue'    -> K13, the per-edge cotangent stored, then K6 scatters it
                   by src (the JAX route when the fused tables exceed 13 MiB);
      'onepass' -> K14, the one-pass backward (FLASH_BWD_MEGA), whose
                   stat table keeps g in f32 (on the card: K2's walk by
                   source on that table).
    The default is the JAX package's default route."""

    softmax_shift: str = "bound"
    bwd: str = "fused"

    def __post_init__(self):
        if self.softmax_shift not in SOFTMAX_SHIFTS:
            raise ValueError(f"softmax_shift {self.softmax_shift!r}: expected one of "
                             f"{SOFTMAX_SHIFTS}")
        if self.bwd not in BACKWARDS:
            raise ValueError(f"bwd {self.bwd!r}: expected one of {BACKWARDS}")
