"""Mean host ms of one ``evaluate`` call, from its call to its return,
before its results are read, over the window's passes outside the
profiled slice."""


def read(r):
    if r.kind != "eval" or not r.issue_s:
        return None
    return 1e3 * sum(r.issue_s) / len(r.issue_s)
