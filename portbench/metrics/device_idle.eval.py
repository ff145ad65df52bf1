"""Share of the profiled slice (first device operation's start to the
last one's end) in which no device operation ran, from the union of their
intervals."""


def read(r):
    if r.kind != "eval" or r.slice is None or r.slice.window_s() <= 0:
        return None
    return 100.0 * (1.0 - r.slice.busy_s() / r.slice.window_s())
