"""The yardstick's float32 operations of one eval pass (the forward and
the pair scorer over every test user's 1 + 99 pairs; pbcore/counts.py)
times the profiled passes, over the slice's seconds and the card's f32
peak."""

from pbcore import counts, peaks


def read(r):
    if r.kind != "eval" or r.slice is None or r.slice.window_s() <= 0:
        return None
    flops = counts.eval_pass_flops(r.groups, r.config["model"], r.config["train"],
                                   r.num_nodes, r.steps_per_channel, r.num_users)
    return 100.0 * flops * r.slice.units / (r.slice.window_s() * peaks.F32_FLOPS)
