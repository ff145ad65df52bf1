"""The yardstick's float32 operations of one training step (forward,
backward at twice the forward, Adam; pbcore/counts.py) times the profiled
steps, over the slice's seconds and the card's f32 peak."""

from pbcore import counts, peaks


def read(r):
    if r.kind != "train" or r.slice is None or r.slice.window_s() <= 0:
        return None
    flops = counts.train_step_flops(r.groups, r.config["model"], r.config["train"],
                                    r.num_nodes, r.steps_per_channel)
    return 100.0 * flops * r.slice.units / (r.slice.window_s() * peaks.F32_FLOPS)
