"""The streaming GAT forward passes of the profiled eval passes: the
yardstick's bound (pbcore/counts.py) over the device time of the kernel
named here (K9)."""

from pbcore import counts

KERNELS = ("stream_gat_fwd_kernel",)


def read(r):
    return counts.kernel_roofline(r, "eval", KERNELS, ("fwd",), stream=True)
