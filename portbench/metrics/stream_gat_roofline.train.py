"""The streaming GAT passes of the profiled steps (forward and backward
over the graphs of at least ``stream_min_edges`` loop-free edges): the
yardstick's bound (pbcore/counts.py) over the device time of the kernels
named here (K9, K10, K11)."""

from pbcore import counts

KERNELS = ("stream_gat_fwd_kernel", "stream_gat_bwd_dst_kernel", "stream_gat_bwd_src_kernel")


def read(r):
    return counts.kernel_roofline(r, "train", KERNELS, ("fwd", "bwd"), stream=True)
