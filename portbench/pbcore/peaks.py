"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the table every share of a roofline or a peak is taken
against.  A card set below 700 W reaches less; the result line carries the
card's name, and PERF.md its power limit."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
