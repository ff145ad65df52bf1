"""Pieces the window drivers share: the training feed, completion marks,
the profiled slice's bookkeeping."""

from __future__ import annotations

import time

import torch

from .trace import Profiler


class Feed:
    """Batches of row ids over random permutations of all `n_rows` rows,
    each padded to whole batches with ``row_mask`` 0 and followed by a new
    one (the program's epoch order, ``GraphEpochEngine._scan``), drawn by
    `generator` on its device."""

    def __init__(self, n_rows, batch_size, generator):
        self.n_rows, self.bs, self.gen = n_rows, batch_size, generator
        self.num_batches = -(-n_rows // batch_size)
        self.device = generator.device
        self._b = self.num_batches

    def _epoch(self):
        n_pad = self.num_batches * self.bs
        perm = torch.randperm(self.n_rows, generator=self.gen, device=self.device)
        self._perm = torch.cat([perm, perm.new_zeros(n_pad - self.n_rows)])
        self._mask = (torch.arange(n_pad, device=self.device) < self.n_rows).float()
        self._b = 0

    def next(self):
        """(rows, row_mask, real rows in the batch)."""
        if self._b == self.num_batches:
            self._epoch()
        w = slice(self._b * self.bs, (self._b + 1) * self.bs)
        real = min(self.bs, self.n_rows - self._b * self.bs)
        self._b += 1
        return self._perm[w], self._mask[w], real


class Marks:
    """Completion marks without a host sync: CUDA events on the card, the
    host clock on the CPU (where every op has finished when it returns)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self._marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append(ev)
        else:
            self._marks.append(time.perf_counter())

    def intervals_ms(self):
        """ms between consecutive marks (the device synchronised first)."""
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self._marks, self._marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self._marks, self._marks[1:])]


class SliceControl:
    """Profiles units [after, after + units) of a traced window; records
    which units ran inside it, so that host spans and intervals of those
    units can be left out of the readings."""

    def __init__(self, device, trace, after, units):
        self.prof = Profiler(device) if trace else None
        self.after, self.units = after, units
        self.inside = set()

    def before(self, i):
        if self.prof is not None and i == self.after:
            self.prof.start()

    def after_unit(self, i):
        if self.prof is None or self.prof.stopped or i < self.after:
            return
        self.inside.add(i)
        self.prof.done += 1
        if self.prof.done == self.units:
            self.prof.stop()

    def close(self):
        """Stop a slice that the window's end cut short."""
        if self.prof is not None and self.prof.done and not self.prof.stopped:
            self.prof.stop()

    def read(self):
        """The slice, or None where nothing was profiled."""
        if self.prof is None or not self.prof.stopped:
            return None
        return self.prof.slice()
