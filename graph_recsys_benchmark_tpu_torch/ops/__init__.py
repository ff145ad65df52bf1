"""The port's ops: the plain segment reductions (``segment``) and the
kernel wrappers (``segment_kernels``, ``gather``, ``flash_gat``,
``batch_gat``, ``stream_gat``)."""

from .segment import segment_max, segment_mean, segment_softmax, segment_sum

__all__ = ["segment_max", "segment_mean", "segment_softmax", "segment_sum"]
