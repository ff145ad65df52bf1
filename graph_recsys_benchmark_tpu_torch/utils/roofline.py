"""Roofline accounting: achieved HBM bandwidth and MFU of a step.

Port of the JAX package's ``utils/roofline.py``.  The workload is
memory-bound (per-edge gathers and reductions dominate; the dense towers
are small), so the honest utilization is the bytes moved a second against
the card's peak, beside the flops a second against its f32 peak.

Peaks of one NVIDIA H100 SXM at its 700 W power limit (NVIDIA's data sheet,
dense rates): HBM3 3.35 TB/s, 67 TFLOP/s in f32 outside the tensor cores
(the rate PERF.md's kernel bounds use), 989 TFLOP/s in bf16 on the tensor
cores.  A card set below 700 W runs below them.

The JAX package reads its counts from XLA's cost model
(``compiled.cost_analysis()``, which takes each Pallas site's declared
``pl.CostEstimate``).  PyTorch has none, so ``count_cost`` counts: it runs
the function once under a dispatch mode that takes each aten op's flops
from ``torch.utils.flop_counter``'s formulas (matrix products; an
elementwise op counts 0) and its bytes as its tensor inputs plus outputs,
each once (views, and the allocations ``empty*``, move nothing and count
nothing).  The kernels are ctypes calls that no dispatch mode sees: their
wrappers declare the terms of their JAX sites (ops/cost.py), and the ops
inside a declared region are not counted again, so a step counts the same
on the CPU and on the card.  Backward passes run under the same mode.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..ops.cost import CostCount, counting

H100_HBM_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_BF16_TENSOR_FLOPS = 989e12

_aten = torch.ops.aten
# ops that move no bytes although their schema does not mark them views
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten._unsafe_view.default}


class _CountingMode(TorchDispatchMode):
    """Adds each aten op's flops and bytes to a CostCount, except inside a
    kernel wrapper's declared region."""

    def __init__(self, count: CostCount):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.count.depth == 0 and not func.is_view and func not in _NO_TRAFFIC:
            formula = flop_registry.get(func._overloadpacket)
            flops = formula(*args, **kwargs, out_val=out) if formula is not None else 0
            seen, nbytes = set(), 0
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    key = (t.untyped_storage().data_ptr(), t.storage_offset(),
                           tuple(t.shape), t.dtype)
                    if key not in seen:
                        seen.add(key)
                        nbytes += t.numel() * t.element_size()
            self.count.add(f"aten.{func._overloadpacket.__name__}", flops, nbytes)
        return out


def count_cost(fn, *args, **kwargs) -> CostCount:
    """Run ``fn(*args, **kwargs)`` once and return its CostCount: totals
    and, by name, each kernel wrapper's declarations and each aten op's
    counts."""
    count = CostCount()
    with counting(count), _CountingMode(count):
        fn(*args, **kwargs)
    return count


def cost_numbers(fn, *args):
    """(flops, bytes_accessed) of one call of ``fn(*args)`` (count_cost)."""
    count = count_cost(fn, *args)
    return float(count.flops), float(count.bytes)


def roofline_report(cost, seconds, steps=1, hbm_peak=H100_HBM_BYTES_PER_S,
                    flops_peak=H100_F32_FLOPS):
    """Roofline summary of work whose count is `cost` = (flops, bytes)
    (cost_numbers; the JAX version takes a compiled executable, which
    PyTorch has not) measured at `seconds` for `steps` logical steps (e.g.
    an epoch of N batches).  {} when seconds <= 0 or no bytes were
    counted."""
    flops, bytes_acc = cost
    if seconds <= 0 or bytes_acc == 0:
        return {}
    return {
        "bytes_per_step": round(bytes_acc / steps),
        "flops_per_step": round(flops / steps),
        "hbm_gbps": round(bytes_acc / seconds / 1e9, 1),
        "hbm_util": round(bytes_acc / seconds / hbm_peak, 4),
        "mfu": round(flops / seconds / flops_peak, 5),
        "arith_intensity": round(flops / max(bytes_acc, 1.0), 3),
    }
