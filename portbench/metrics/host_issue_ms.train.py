"""Mean host ms of one ``train_step`` call, from its call to its return
(the benchmark's own span), over the window's steps outside the
profiled slice."""


def read(r):
    if r.kind != "train" or not r.issue_s:
        return None
    return 1e3 * sum(r.issue_s) / len(r.issue_s)
