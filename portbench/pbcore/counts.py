"""The frozen yardstick: operations and bytes of PEAGAT's work, from the
configuration's shapes and each step graph's edge count in the dataset's
own arrays, whatever implements them.

One GAT attention pass over a step graph of E loop-free edges and one
implicit self-loop a node, N rows, C channels that share the graph and kz
feature columns (``attention``):

  forward   reads z [C, N, kz], a_src and a_dst [C, N] and the edge list
            (src, dst int32 [E]); writes out [C, N, kz].  Operations a
            channel: (E + N) x (2 kz + 5) (logit add, leaky ReLU, shifted
            exp, denominator add, weighted row sum) + N kz (normalize).
  backward  reads z, a_src, a_dst, the incoming gradient [C, N, kz], two
            row statistics [C, N] (log-denominator, <g, out>) and the edge
            list; writes dz [C, N, kz], da_src and da_dst [C, N].
            Operations: (E + N) x (4 kz + 10) a channel.

Each input byte is counted once and each output byte once.  Graphs whose
loop-free edge count reaches ``stream_min_edges`` (the configuration's
copy of the program's routing rule when this yardstick was written) are
the streaming passes; the others the composed convs.  The whole step's
operations (``train_step_flops``, ``eval_pass_flops``) are the model's own:
every conv's z = h W over all N rows, its attention, the channel fusion,
the pair scorer over the scored pairs, the losses; backward counts twice
the forward, and Adam 12 operations a parameter.
"""

from __future__ import annotations

import dataclasses

from . import peaks
from .reference import layer_dims, leaf_table, loop_free_count


@dataclasses.dataclass(frozen=True)
class Group:
    """Channels that share one step graph at one step."""

    step: int
    relation: str
    edges: int  # loop-free
    channels: tuple
    stream: bool


def graph_groups(edge_index, metapaths, stream_min_edges):
    """The step graphs of the metapath table, grouped by (step, relation)."""
    groups: dict = {}
    for c, steps in enumerate(metapaths):
        for k, rel in enumerate(steps):
            groups.setdefault((k, rel), []).append(c)
    out = []
    for (k, rel), chans in groups.items():
        e = loop_free_count(edge_index, rel)
        out.append(Group(step=k, relation=rel, edges=e, channels=tuple(chans),
                         stream=e >= stream_min_edges))
    return out


def attention(edges, rows, channels, kz, direction):
    """(operations, bytes) of one GAT attention pass (module docstring)."""
    c, e, n = channels, edges, rows
    if direction == "fwd":
        flops = c * ((e + n) * (2 * kz + 5) + n * kz)
        nbytes = 4 * c * n * (kz + 2) + 8 * e + 4 * c * n * kz
    elif direction == "bwd":
        flops = c * (e + n) * (4 * kz + 10)
        nbytes = 4 * c * n * (2 * kz + 4) + 8 * e + 4 * c * n * (kz + 2)
    else:
        raise ValueError(direction)
    return flops, nbytes


def bound_s(flops, nbytes):
    """The least time of one call: bytes at the HBM rate or f32 operations
    at the f32 peak, the larger."""
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.F32_FLOPS)


def attention_bound_s(groups, model, num_nodes, steps_per_channel, directions, stream):
    """Summed bound of the attention passes of one step (the groups with
    ``stream`` as given; a pass a head), in each of `directions`."""
    total = 0.0
    for g in groups:
        if g.stream != stream:
            continue
        _, dout, heads = layer_dims(model, steps_per_channel[g.channels[0]])[g.step]
        for d in directions:
            total += heads * bound_s(*attention(g.edges, num_nodes, len(g.channels), dout, d))
    return total


def kernel_roofline(r, kind, kernels, directions, stream):
    """A roofline share in %: the bound of a step's (or pass's) attention
    passes over the profiled units, over the device time of `kernels` in
    the slice; None where the cell is not `kind` or the slice holds none."""
    if r.kind != kind or r.slice is None:
        return None
    t = r.slice.kernel_s(kernels)
    if t <= 0:
        return None
    bound = attention_bound_s(r.groups, r.config["model"], r.num_nodes,
                              r.steps_per_channel, directions, stream)
    return 100.0 * bound * r.slice.units / t


def forward_flops(groups, model, num_nodes, num_channels, steps_per_channel):
    """Operations of one full-graph forward: every conv, ReLU, fusion."""
    n, r = num_nodes, model["repr_dim"]
    flops = 0
    for g in groups:
        din, dout, heads = layer_dims(model, steps_per_channel[g.channels[0]])[g.step]
        kz = heads * dout
        per = 2 * n * din * kz + 4 * n * kz + n * kz  # z = h W, a_src / a_dst, bias
        if g.step < steps_per_channel[g.channels[0]] - 1:
            per += n * kz  # ReLU
        flops += len(g.channels) * per
        flops += heads * attention(g.edges, n, len(g.channels), dout, "fwd")[0]
    flops += n * num_channels * (4 * r + 4)  # channel attention and weighted sum
    return flops


def scorer_flops(pairs, r):
    """fc1 over [u | i], its bias and ReLU, fc2 and its bias."""
    return pairs * (2 * (2 * r) * r + 2 * r + 2 * r + 1)


def parameter_count(model, num_nodes, steps_per_channel):
    total = 0
    for _, shape, _ in leaf_table(model, num_nodes, steps_per_channel):
        size = 1
        for s in shape:
            size *= s
        total += size
    return total


def train_step_flops(groups, model, train, num_nodes, steps_per_channel):
    b, r, emb = train["batch_size"], model["repr_dim"], model["emb_dim"]
    fwd = forward_flops(groups, model, num_nodes, len(steps_per_channel), steps_per_channel)
    fwd += scorer_flops(2 * b, r) + 8 * b  # pos and neg scores, BPR
    if model["entity_aware"]:
        fwd += b * (4 * 3 * emb + 12)  # four squared distances, two terms
    return 3 * fwd + 12 * parameter_count(model, num_nodes, steps_per_channel)


def eval_pass_flops(groups, model, train, num_nodes, steps_per_channel, num_users):
    pairs = num_users * (1 + train["num_neg_candidates"])
    fwd = forward_flops(groups, model, num_nodes, len(steps_per_channel), steps_per_channel)
    return fwd + scorer_flops(pairs, model["repr_dim"]) + 3 * pairs
