"""The profiled slice of a traced run: torch.profiler over a fixed number of
steps or passes inside the window, read into device intervals.

``Slice`` holds every device operation of the slice (kernels, copies,
fills) as (name, start_ns, end_ns) and the host's operations, and gives
the arithmetic the per-layer readers share: the busy time as the union of
the device intervals (``busy_s``), the slice's length from its first
device operation's start to its last one's end (``window_s``), the device
time of named kernels, and the breakdown: the device operations that took
most time, and the longest idle gaps by the innermost host operation that
was running at each gap's middle.  No Chrome trace is written.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import torch


class Profiler:
    """Starts and stops torch.profiler around the slice; the device is
    synchronised at both ends so that the slice holds its own work."""

    def __init__(self, device: torch.device):
        self.device = device
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self.done = 0
        self.stopped = False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._prof.start()

    def stop(self):
        self._sync()
        self._prof.stop()
        self.stopped = True

    def slice(self):
        """The stopped slice, read (after the window: reading takes time)."""
        return Slice.from_profiler(self._prof, self.done)


@dataclasses.dataclass
class Slice:
    device_ops: list  # (name, start_ns, end_ns)
    host_ops: list  # (name, start_ns, end_ns)
    units: int  # steps or passes profiled

    @classmethod
    def from_profiler(cls, prof, units):
        dev, host = [], []
        for ev in prof.profiler.kineto_results.events():
            if ev.is_user_annotation():
                continue
            rec = (ev.name(), ev.start_ns(), ev.end_ns())
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append(rec)
            elif ev.device_type() == torch.autograd.DeviceType.CPU:
                host.append(rec)
        dev.sort(key=lambda r: r[1])
        host.sort(key=lambda r: r[1])
        return cls(device_ops=dev, host_ops=host, units=units)

    def merged(self):
        """The union of the device intervals, as sorted (start, end) pairs."""
        out = []
        for _, s, e in self.device_ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self):
        return sum(e - s for s, e in self.merged()) / 1e9

    def window_s(self):
        if not self.device_ops:
            return 0.0
        return (max(e for _, _, e in self.device_ops) - self.device_ops[0][1]) / 1e9

    def kernel_s(self, names):
        """Device seconds of the operations whose name holds any of `names`."""
        return sum(e - s for n, s, e in self.device_ops if any(k in n for k in names)) / 1e9

    def top_ops(self, limit=10):
        by = collections.Counter()
        for n, s, e in self.device_ops:
            by[n] += (e - s) / 1e9
        return [[n, s] for n, s in by.most_common(limit)]

    def idle_gaps(self, limit=10, longest=500):
        """The `longest` idle gaps between device operations, summed by the
        innermost host operation running at each gap's middle."""
        spans = self.merged()
        gaps = sorted(((s1 - e0, e0, s1) for (_, e0), (s1, _) in zip(spans, spans[1:])),
                      reverse=True)[:longest]
        starts = [s for _, s, _ in self.host_ops]
        by = collections.Counter()
        for length, e0, s1 in gaps:
            mid = (e0 + s1) // 2
            label = "(no host operation)"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - 2000), -1):
                name, s, e = self.host_ops[j]
                if s <= mid <= e:
                    label = name
                    break
            by[label] += length / 1e9
        return [[n, s] for n, s in by.most_common(limit)]
