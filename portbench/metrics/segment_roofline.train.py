"""The composed GAT convs of the profiled steps (the graphs under
``stream_min_edges`` loop-free edges, their self-loops as edges): the
yardstick's bound for their attention forward and backward
(pbcore/counts.py) over the device time of the gather, segment-sum /
scatter and softmax-statistics kernels named here (K7, K5/K6, K8)."""

from pbcore import counts

KERNELS = ("row_gather_kernel", "scatter_add_kernel", "softmax_block_kernel")


def read(r):
    return counts.kernel_roofline(r, "train", KERNELS, ("fwd", "bwd"), stream=False)
