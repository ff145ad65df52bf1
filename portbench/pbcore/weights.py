"""The run's weights, made by the benchmark from the seed on the device.

One ``torch.rand`` over every parameter's elements on the run's generator,
then each leaf cut from it and scaled to its uniform bound
(``reference.leaf_table``: glorot bounds over each leaf's own fan, biases
at 1/sqrt(fan in), the embedding table at the configuration's
``table_bound``).  The same values go to the program (its model object,
built from them) and, as CPU copies, to the reference.
"""

from __future__ import annotations

import math

import torch

from .reference import leaf_table


def make_leaves(model: dict, num_nodes, steps_per_channel, generator, device):
    """{name: tensor} on `device`, drawn by `generator` (on `device`)."""
    table = leaf_table(model, num_nodes, steps_per_channel)
    total = sum(math.prod(shape) for _, shape, _ in table)
    u = torch.rand(total, generator=generator, device=device)
    out, off = {}, 0
    for name, shape, bound in table:
        n = math.prod(shape)
        out[name] = ((u[off:off + n] * 2.0 - 1.0) * bound).reshape(shape)
        off += n
    return out


def program_model(model_cls, leaves: dict, steps_per_channel):
    """The program's model object holding `leaves` (its constructor's
    layout: x, channels[c][k] = {w, att, b}, fc1, fc2, att); raises if its
    parameters are not exactly the leaves by name and shape."""
    channels = [[{f: leaves[f"channels.{c}.{k}.{f}"] for f in ("w", "att", "b")}
                 for k in range(n)] for c, n in enumerate(steps_per_channel)]
    fc1 = {"w": leaves["fc1.w"], "b": leaves["fc1.b"]}
    fc2 = {"w": leaves["fc2.w"], "b": leaves["fc2.b"]}
    params = model_cls(leaves["x"], channels, fc1, fc2, att=leaves["att"])
    got = {k: tuple(v.shape) for k, v in params.named_parameters()}
    want = {k: tuple(v.shape) for k, v in leaves.items()}
    if got != want:
        raise ValueError(f"the program's parameters {got} are not the benchmark's {want}")
    return params
