"""BPR rows with row_mask 1 over the seconds between step completions
(CUDA events after each ``train_step``) in the traced run, the profiled
slice's steps and the step after it left out: the ML-25M train cell's pace,
read per layer.  Its pace spread too widely between runs for a bound
(PERF.md), so the cell keeps only its peak memory and set-up end to end,
and this reading names the peak memory as what it moves."""


def read(r):
    if r.kind != "train" or not r.intervals_ms:
        return None
    return 1e3 * sum(r.interval_work) / sum(r.intervals_ms)
