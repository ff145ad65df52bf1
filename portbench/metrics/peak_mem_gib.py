"""torch.cuda.max_memory_allocated over set-up and window, in GiB."""


def read(r):
    if not r.peak_bytes:
        return None
    return r.peak_bytes / 2**30
