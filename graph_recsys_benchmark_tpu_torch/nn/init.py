"""Parameter initializers matching the reference's torch/PyG initialization.

Port of the JAX package's ``nn/init.py`` with explicit ``torch.Generator``s.
The draws follow the same distributions, not the same random stream:
the reference initializes the whole node embedding table with PyG `glorot`
over (num_nodes, emb_dim) (models/base.py:156,183); linear layers keep
torch's default bias (fan-in uniform) and may re-initialize the weight with
glorot (models/base.py:186-189).  Values are drawn on the CPU from the
generator, so one seed gives the same weights on every device.
"""

from __future__ import annotations

import math

import torch


def uniform(generator, shape, bound):
    """U(-bound, bound) drawn on the CPU from `generator`."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (2.0 * bound) - bound


def glorot(generator, shape):
    """PyG `torch_geometric.nn.inits.glorot`: U(-a, a) with
    a = sqrt(6 / (shape[-2] + shape[-1]))."""
    return uniform(generator, shape, math.sqrt(6.0 / (shape[-2] + shape[-1])))


def torch_linear_weight(generator, in_dim, out_dim):
    """torch.nn.Linear default weight init (kaiming_uniform with
    a=sqrt(5), i.e. U(-1/sqrt(fan_in), 1/sqrt(fan_in))), stored transposed
    to [in, out] for `x @ w`."""
    return uniform(generator, (in_dim, out_dim), math.sqrt(1.0 / in_dim))


def torch_linear_bias(generator, in_dim, out_dim):
    """torch.nn.Linear default bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return uniform(generator, (out_dim,), math.sqrt(1.0 / in_dim))


def torch_linear_params(generator, in_dim, out_dim, glorot_weight=False):
    """Linear layer params {w: [in, out], b: [out]} (JAX layout: x @ w).

    glorot_weight=True re-initializes the weight with PyG glorot and keeps
    the torch-default bias, the reference's fc1/fc2 pattern."""
    if glorot_weight:
        w = glorot(generator, (in_dim, out_dim))
    else:
        w = torch_linear_weight(generator, in_dim, out_dim)
    return {"w": w, "b": torch_linear_bias(generator, in_dim, out_dim)}


def linear(params, x):
    return x @ params["w"] + params["b"]


def _parameter_dict(tree):
    return torch.nn.ParameterDict({k: torch.nn.Parameter(v) for k, v in tree.items()})


class ParamTree(torch.nn.Module):
    """Parameters in the layout and names of a JAX params dict: a tensor
    leaf becomes a Parameter under its key, a dict of tensors a
    ParameterDict, a tuple of such dicts a ModuleList of them (HeRec's
    ``trans``), so carrying weights across is a copy (models/params.py)."""

    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _parameter_dict(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, torch.nn.ModuleList(_parameter_dict(d) for d in v))
            else:
                self.register_parameter(k, torch.nn.Parameter(v))

    def tree(self):
        """The JAX layout: {key: tensor, {key: tensor} or a tuple of them} of
        the Parameters."""
        out = {}
        for k, m in self.named_children():
            if isinstance(m, torch.nn.ModuleList):
                out[k] = tuple(dict(d.items()) for d in m)
            else:
                out[k] = dict(m.items())
        for k, p in self.named_parameters(recurse=False):
            out[k] = p
        return out
