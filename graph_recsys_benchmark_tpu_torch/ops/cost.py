"""The declared cost of each kernel wrapper, for utils/roofline.cost_numbers.

PyTorch has no cost model of a program, so utils/roofline counts one: it
runs the program under a dispatch mode that counts each aten op's flops
and bytes.  The kernels are called through ctypes and no dispatch mode
sees them, so each kernel wrapper declares its cost instead
(``declares``): the terms of its JAX call site's ``pl.CostEstimate``,
unpadded.  Every padded size is the true one (``e_pad`` the edges the
wrapper is given, ``k_pad`` its row width, ``n_pad``, ``n_src_pad`` and
``n_out`` its rows) and every TPU tile or window factor (the one-hot
tiles ``_R`` and ``_BR``, the chunk ``_FC``, the scatter's row tiles) is 1,
the one row that a gather or a scatter touches per edge on the card; the
JAX formulas' stat columns (the 8, 3, 16, 32 and 48) stay as they are.

A wrapper declares its cost whether its kernel or its plain version runs,
and the ops inside a declared region are not counted again, so a step
counts the same on the CPU and on the card: the work, not what
implements it.  Regions nest: only the outermost one counts.

The sites (graph_recsys_benchmark_tpu/ops/...):
  K5 sorted_segment_sum   pallas_segment.py:203
  K7 sorted_broadcast     pallas_segment.py:580
  K6 localized_scatter_add pallas_segment.py:741
  K1/K12 flash_gat_fwd    flash_gat.py:654
  K12-online walk         flash_gat.py:803 (flash_gat_fwd_online)
  K2 flash_gat_bwd        flash_gat.py:1061, fused_scatter
  K13 flash_gat_bwd_glue  flash_gat.py:1061, not fused_scatter
  K14 flash_gat_bwd_onepass flash_gat.py:1295
  K3 batch_gat_fwd        batch_gat.py:473
  K4 batch_gat_bwd        batch_gat.py:595
  K9, K10, K11 stream_gat_* stream_gat.py:499 (the terms of :518, :536, :553)
K8 (``softmax_stats``, pallas_segment.py:244) and the online row max
(``gat_rowmax``, the first pass of the port's K12-online) have no JAX site
of their own: they declare their inputs read once, their outputs written
once and two operations an edge.
"""

from __future__ import annotations

import contextlib
import functools


class CostCount:
    """Running totals of one count: flops, bytes, and both by name (a
    kernel wrapper's name, or ``aten.<op>``)."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.by_name: dict = {}
        self.depth = 0  # > 0 inside a declared region

    def add(self, name, flops, nbytes):
        self.flops += flops
        self.bytes += nbytes
        f, b, n = self.by_name.get(name, (0, 0, 0))
        self.by_name[name] = (f + flops, b + nbytes, n + 1)

    @contextlib.contextmanager
    def declared(self, name, flops, nbytes):
        """A kernel's region: `flops` and `nbytes` counted once (unless an
        outer region is open), nothing inside counted again."""
        if self.depth == 0:
            self.add(name, flops, nbytes)
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1


# the counts being taken, innermost last (utils/roofline.count_cost)
_COUNTS: list = []


def active():
    """The innermost CostCount being taken, or None."""
    return _COUNTS[-1] if _COUNTS else None


@contextlib.contextmanager
def counting(count: CostCount):
    _COUNTS.append(count)
    try:
        yield count
    finally:
        _COUNTS.pop()


def declares(name, cost):
    """Decorator of a kernel wrapper: while a count is taken, the call runs
    inside a region that declares ``cost(*args, **kwargs)`` = (flops,
    bytes) under `name`.  Outside a count it adds one list test a call."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            count = active()
            if count is None:
                return fn(*args, **kwargs)
            with count.declared(name, *cost(*args, **kwargs)):
                return fn(*args, **kwargs)

        return wrapper

    return deco


# ---------------------------------------------------------------- the formulas
# e: edges; n: rows (num_rows); n_src: the table's rows; k: row width;
# isz: the transport's bytes an element.


def segsum_cost(e, d, n, isz):
    """K5, pallas_segment.py:203."""
    return 2 * e * d, e * d * isz + e * 4 + n * d * 4


def gather_cost(e, k, n, isz):
    """K7, pallas_segment.py:580."""
    return 2 * e * k, e * (4 + 4 * k) + n * isz * k


def scatter_cost(e, k, n, isz):
    """K6, pallas_segment.py:741."""
    return 2 * e * k, e * (4 + isz * k) + n * 4 * k


def softmax_stats_cost(e, n):
    """K8: alpha and dst read, [max | sum] written."""
    return 2 * e, e * 8 + n * 8


def flash_fwd_cost(e, kz, n, n_src, isz):
    """K1/K12, flash_gat.py:654."""
    k = kz + 1
    return 2 * e * k * 3, e * 8 + k * n_src * isz + n * (k + 8) * 4


def flash_fwd_online_cost(e, kz, n, isz):
    """K12-online, flash_gat.py:803."""
    k = kz + 1
    return 2 * e * k * 2, e * 8 + e * 2 * k * isz + n * (k + 3) * 4


def rowmax_cost(e, n, n_src, isz):
    """gat_rowmax: ids, a_src and adst_r read, m written."""
    return 2 * e, e * 8 + n_src * isz + n * 8


def flash_bwd_cost(e, kz, n, n_src, isz, fused_scatter):
    """K2 (fused_scatter) and K13, flash_gat.py:1061."""
    k, kg = kz + 1, kz + 3
    flops = 2 * e * (k * (2 if fused_scatter else 1) + kg * 2 + 1)
    nbytes = (e * 8 + k * n_src * isz + kg * n * 4
              + (k * n_src * 4 if fused_scatter else k * e * isz) + n * 4)
    return flops, nbytes


def flash_bwd_onepass_cost(e, kz, n, n_src, isz):
    """K14, flash_gat.py:1295."""
    k, kg = kz + 1, kz + 3
    return 2 * e * (k + kg) * 2 * 2, e * 8 + n * kg * 4 + k * n_src * (isz + 4)


def batch_fwd_cost(e, kz, n_ch, n, n_src, isz):
    """K3, batch_gat.py:473."""
    k = n_ch * (kz + 1)
    return 2 * e * k * (2 + 16), e * 8 + k * n_src * isz + n * (k + 16) * 4


def batch_bwd_cost(e, kz, n_ch, n, n_src, isz):
    """K4, batch_gat.py:595."""
    k = n_ch * (kz + 1)
    return (2 * e * k * (4 + 48),
            e * 8 + k * (n_src * isz + n * 4) + n_src * k * 4 + n * 32)


def stream_cost(kernel, e, kz, n_ch, n, isz):
    """K9 ('fwd'), K10 ('bwd_dst'), K11 ('bwd_src'): stream_gat.py:518,
    :536, :553 (the stream's band kz + 3 columns a channel)."""
    k = n_ch * (kz + 3)
    flops = 2 * e * k * (4 if kernel == "bwd_src" else 2)
    return flops, e * (k * isz + 4) + n * k * (8 if kernel == "bwd_dst" else 12)
