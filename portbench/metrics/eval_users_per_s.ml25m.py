"""Test users ranked (every user each pass, 1 + 99 candidates) over the
seconds of the passes, each from its call to its metrics on the host, in
the traced run, the profiled slice's passes left out: the ML-25M eval's
pace, read per layer.  Its pace spread too widely between runs for a bound
(PERF.md), so the cell keeps only its peak memory and set-up end to end."""


def read(r):
    if r.kind != "eval" or not r.pass_s:
        return None
    return r.num_users * len(r.pass_s) / sum(r.pass_s)
