"""95th percentile of the ms between consecutive step completions (CUDA
events after each ``train_step``, no host sync between steps) in the
traced run, the profiled slice's steps and the step after it left out: the
tail of a cell whose card idles most of the window, paced by the host."""

import statistics


def read(r):
    if r.kind != "train" or len(r.intervals_ms) < 20:
        return None
    return statistics.quantiles(r.intervals_ms, n=20)[-1]
