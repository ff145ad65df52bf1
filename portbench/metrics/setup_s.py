"""Process start to the first timed step or pass: imports, CUDA, the
dataset (cached after a checkout's first run), the trainer's graphs, the
kernels' build on a checkout's first run, the weights, the warm-up."""


def read(r):
    return r.setup_s
