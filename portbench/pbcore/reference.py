"""Plain reference of PEAGAT: forward, BPR + entity loss, gradients, Adam,
the ranking eval.  Plain PyTorch in the dtype of the weights it is given
(float64 for the training check, float32 for the eval's scores); imports
nothing of the program.

It follows the published model (PEAGNN, reference ``models/base.py`` and
``models/peagat.py`` on PyTorch-Geometric 1.5's ``GATConv``) from the
dataset's own arrays:

  * the metapath graphs are rebuilt here from ``edge_index`` and the
    configuration's metapath table: one graph a channel and step, the
    relation's (src, dst) or reversed, self-loops removed and one added a
    node (GATConv's ``remove_self_loops`` / ``add_self_loops``);
  * a GAT conv: z = h W, a logit a_dst[i] + a_src[j] per edge (j -> i),
    leaky ReLU 0.2, softmax over each destination's edges with PyG's
    +1e-16 guard, out_i = sum alpha z_j + b; heads concatenate; ReLU
    between steps;
  * channels fuse by attention (softmax over channels of <h, att_c>), the
    pair scorer is relu(cat(u, i) fc1) fc2, the loss BPR summed over the
    masked rows plus 0.1 x the entity regularizer (base.py:43-80);
  * Adam as ``torch.optim.Adam`` (L2 weight decay added to the gradient).

``precision="tf32"`` rounds every matrix product's inputs to TF32 (10
explicit mantissa bits, nearest, ties away from zero, as the tensor cores
take them), products summed in f32: the control, one precision below the
configuration's float32 with TF32 off.  The caller keeps
``torch.backends.cuda.matmul.allow_tf32`` off.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """t (float32) rounded to TF32's 10-bit mantissa, nearest, ties away
    from zero; the exponent range is float32's."""
    bits = t.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both inputs rounded to TF32, in the forward and in the
    two products of the backward, as TF32 tensor-core products run."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32_round(g)
        return rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg


class Precision:
    def __init__(self, name="f32"):
        if name not in ("f32", "tf32"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def mm(self, a, b):
        if self.name == "tf32":
            return _TF32MatMul.apply(a, b)
        return a @ b


# ---------------------------------------------------------------- layout


def layer_dims(model: dict, num_steps: int):
    """Per step (in, out, heads) of a channel of `num_steps` convs
    (peagat.py): emb -> hidden (x heads) ... -> repr, one head last."""
    if num_steps == 1:
        return [(model["emb_dim"], model["repr_dim"], 1)]
    h = model["num_heads"]
    dims = [(model["emb_dim"], model["hidden_size"], h)]
    for _ in range(num_steps - 2):
        dims.append((model["hidden_size"] * h, model["hidden_size"], h))
    dims.append((model["hidden_size"] * h, model["repr_dim"], 1))
    return dims


def leaf_table(model: dict, num_nodes: int, steps_per_channel):
    """[(name, shape, bound)] of every parameter, in the program's names.
    The embedding table has num_nodes rows padded to a multiple of 128
    (the program's layout; rows past num_nodes are never read)."""
    emb, r = model["emb_dim"], model["repr_dim"]
    emb_rows = -(-num_nodes // 128) * 128
    out = [("x", (emb_rows, emb), model["table_bound"])]
    for c, num_steps in enumerate(steps_per_channel):
        for k, (din, dout, heads) in enumerate(layer_dims(model, num_steps)):
            p = f"channels.{c}.{k}."
            out.append((p + "w", (din, heads * dout), math.sqrt(6.0 / (din + heads * dout))))
            out.append((p + "att", (1, heads, 2 * dout), math.sqrt(6.0 / (heads + 2 * dout))))
            out.append((p + "b", (heads * dout,), 1.0 / math.sqrt(din)))
    n_ch = len(steps_per_channel)
    if model["channel_aggr"] != "att":
        raise ValueError("the reference fuses channels by attention only")
    out.append(("att", (1, n_ch, r), math.sqrt(6.0 / (n_ch + r))))
    out.append(("fc1.w", (2 * r, r), math.sqrt(6.0 / (3 * r))))
    out.append(("fc1.b", (r,), 1.0 / math.sqrt(2 * r)))
    out.append(("fc2.w", (r, 1), math.sqrt(6.0 / (r + 1))))
    out.append(("fc2.b", (1,), 1.0 / math.sqrt(r)))
    return out


# ---------------------------------------------------------------- graphs


def relation_edges(edge_index, step):
    """(src, dst) int64 numpy arrays of one metapath step: a relation name,
    reversed where it starts with 'rev:'."""
    if step.startswith("rev:"):
        e = edge_index[step[4:]]
        return np.asarray(e[1]), np.asarray(e[0])
    e = edge_index[step]
    return np.asarray(e[0]), np.asarray(e[1])


def loop_free_count(edge_index, step):
    src, dst = relation_edges(edge_index, step)
    return int(np.count_nonzero(src != dst))


def build_graphs(edge_index, metapaths, num_nodes, device):
    """One (src, dst) int64 pair a channel and step on `device`, self-loops
    replaced by one a node; steps of one relation share a pair."""
    built = {}
    loops = torch.arange(num_nodes, dtype=torch.int64, device=device)
    out = []
    for steps in metapaths:
        ch = []
        for step in steps:
            if step not in built:
                src, dst = relation_edges(edge_index, step)
                keep = src != dst
                s = torch.as_tensor(src[keep], dtype=torch.int64, device=device)
                d = torch.as_tensor(dst[keep], dtype=torch.int64, device=device)
                built[step] = (torch.cat([s, loops]), torch.cat([d, loops]))
            ch.append(built[step])
        out.append(ch)
    return out


# ---------------------------------------------------------------- model


def gat_conv(prec, h, w, att, b, src, dst, n, heads):
    """PyG 1.5 GATConv (concat heads) over edges (src -> dst) that hold one
    self-loop a node -> [n, heads * dout]."""
    z = prec.mm(h[:n], w).reshape(n, heads, -1)  # [n, H, d]
    d = z.shape[-1]
    outs = []
    for hh in range(heads):
        zh = z[:, hh]
        a_dst = prec.mm(zh, att[0, hh, :d, None])[:, 0]  # target (x_i) first
        a_src = prec.mm(zh, att[0, hh, d:, None])[:, 0]
        logit = F.leaky_relu(a_dst[dst] + a_src[src], 0.2)
        m = torch.full((n,), -math.inf, dtype=logit.dtype, device=logit.device)
        m = m.scatter_reduce(0, dst, logit.detach(), "amax")  # a shift: it cancels
        e = torch.exp(logit - m[dst])
        s = torch.zeros(n, dtype=e.dtype, device=e.device).index_add(0, dst, e)
        alpha = e / (s[dst] + 1e-16)
        outs.append(torch.zeros(n, d, dtype=z.dtype, device=z.device)
                    .index_add(0, dst, zh[src] * alpha[:, None]))
    return torch.cat(outs, dim=1) + b


def forward(leaves, graphs, model, num_nodes, prec):
    """Cached representation of every node [num_nodes, repr]."""
    hs = []
    for c, steps in enumerate(graphs):
        dims = layer_dims(model, len(steps))
        h = leaves["x"]
        for k, (src, dst) in enumerate(steps):
            p = f"channels.{c}.{k}."
            h = gat_conv(prec, h, leaves[p + "w"], leaves[p + "att"], leaves[p + "b"],
                         src, dst, num_nodes, dims[k][2])
            if k < len(steps) - 1:
                h = torch.relu(h)
        hs.append(h)
    hc = torch.stack(hs, dim=1)  # [N, C, R]
    atts = torch.softmax(torch.sum(hc * leaves["att"], dim=-1), dim=-1)
    return torch.sum(hc * atts[..., None], dim=1)


def predict(leaves, rep, u, i, prec):
    z = torch.cat([rep[u], rep[i]], dim=-1)
    z = torch.relu(prec.mm(z, leaves["fc1.w"]) + leaves["fc1.b"])
    return (prec.mm(z, leaves["fc2.w"]) + leaves["fc2.b"])[:, 0]


def loss(leaves, graphs, model, num_nodes, batch, mask, prec):
    """BPR over the masked rows plus coff x the entity regularizer; batch
    columns [u, pos, neg, pos_item_ent, neg_item_ent, item_mask,
    pos_user_ent, neg_user_ent, user_mask]."""
    rep = forward(leaves, graphs, model, num_nodes, prec)
    pos = predict(leaves, rep, batch[:, 0], batch[:, 1], prec)
    neg = predict(leaves, rep, batch[:, 0], batch[:, 2], prec)
    total = torch.sum(F.softplus(-(pos - neg)) * mask)
    if model["entity_aware"]:
        x = leaves["x"]

        def sq(a, b):
            d = x[a] - x[b]
            return torch.sum(d * d, dim=-1)

        item = F.softplus(-((sq(batch[:, 1], batch[:, 3]) - sq(batch[:, 1], batch[:, 4]))
                            * batch[:, 5]))
        user = F.softplus(-((sq(batch[:, 0], batch[:, 6]) - sq(batch[:, 0], batch[:, 7]))
                            * batch[:, 8]))
        total = total + model["entity_aware_coff"] * torch.sum((item + user) * mask)
    return total * model.get("loss_scale", 1.0)


def adam_step(leaves, grads, state, t, lr, wd, b1=0.9, b2=0.999, eps=1e-8):
    """torch.optim.Adam's step t (1-based) in place; returns the gradients
    as the optimizer takes them (with the weight decay)."""
    taken = {}
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    with torch.no_grad():
        for name, p in leaves.items():
            g = grads[name] + wd * p
            taken[name] = g
            m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
            m.lerp_(g, 1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.addcdiv_(m, v.sqrt() / math.sqrt(bc2) + eps, value=-lr / bc1)
    return taken


def train_steps(p0, graphs, model, num_nodes, batches, masks, lr, wd, prec, device):
    """Follow the program's first steps from the weights p0 (name -> CPU
    tensor) on the same batches: the losses, the loss gradients and the
    gradients as Adam takes them at step 1, the weights after the last."""
    leaves = {k: v.to(device).clone().requires_grad_(True) for k, v in p0.items()}
    state, losses, grad1, taken1 = {}, [], None, None
    for t, (batch, mask) in enumerate(zip(batches, masks), start=1):
        for p in leaves.values():
            p.grad = None
        value = loss(leaves, graphs, model, num_nodes, batch.long(), mask.float(), prec)
        grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        taken = adam_step(leaves, grads, state, t, lr, wd)
        losses.append(float(value.detach()))
        if t == 1:
            grad1 = {k: g.detach().cpu() for k, g in grads.items()}
            taken1 = {k: g.detach().cpu() for k, g in taken.items()}
    final = {k: p.detach().cpu() for k, p in leaves.items()}
    return losses, grad1, taken1, final


# ---------------------------------------------------------------- rules


def batch_violations(batch, rows, arrays, num_negative, strategy, entity_aware):
    """Rows of a training batch that break its sampling rule: (u, pos) the
    interaction rows % Ei of train_pos; the negative an item ('random':
    uniform over the item range); the entity columns: the positive entity
    one of the node's features (0 and mask 0 without features), the
    corrupted one in the positive entity's type range."""
    tp = arrays["train_pos"]
    inter = rows.long() % tp.shape[0]
    bad = (batch[:, 0] != tp[inter, 0]) | (batch[:, 1] != tp[inter, 1])
    lo, n_items = arrays["item_lo"], arrays["num_items"]
    neg = batch[:, 2]
    if strategy != "random":
        raise ValueError(f"sampling {strategy!r}: the reference checks 'random'")
    bad |= (neg < lo) | (neg >= lo + n_items)
    if entity_aware:
        for col0, feat, counts, base in (
                (3, arrays["item_feat"], arrays["item_feat_counts"], batch[:, 1] - lo),
                (6, arrays["user_feat"], arrays["user_feat_counts"],
                 batch[:, 0] - arrays["user_lo"])):
            pos_e, neg_e, m = batch[:, col0], batch[:, col0 + 1], batch[:, col0 + 2]
            cnt = counts[base.long()]
            has = cnt > 0
            width = feat.shape[1]
            in_list = ((feat[base.long()] == pos_e[:, None])
                       & (torch.arange(width, device=feat.device)[None, :] < cnt[:, None]))
            ok_pos = torch.where(has, in_list.any(dim=1), pos_e == 0)
            lo_e = arrays["ent_lo"][pos_e.long()]
            hi_e = arrays["ent_hi"][pos_e.long()]
            ok_neg = torch.where(has, (neg_e >= lo_e) & (neg_e < hi_e), neg_e == 0)
            bad |= ~ok_pos | ~ok_neg | (m != has.long())
    return int(bad.sum())


def negative_violations(neg, users_local, seen_keys, item_lo, num_items):
    """Eval negatives [U, C] outside the item range or in the user's seen
    set (train history and test item); seen_keys: sorted int64 keys
    u_local * num_items + item_local."""
    local = neg.long() - item_lo
    out_of_range = (local < 0) | (local >= num_items)
    keys = users_local.long()[:, None] * num_items + local.clamp(0, num_items - 1)
    pos = torch.searchsorted(seen_keys, keys.reshape(-1)).clamp(max=seen_keys.numel() - 1)
    seen = (seen_keys[pos] == keys.reshape(-1)).reshape(keys.shape)
    return int((out_of_range | seen).sum())


def rank_gap(ranks, s_pos, s_neg):
    """The widest score margin by which the program's rank of a user's
    positive departs from the reference's scores, over the median |s_neg -
    s_pos|: 0 where each rank is the count of negatives scored above the
    positive; r consistent with margin t needs the r-th highest gap >= -t
    and the (r+1)-th <= t."""
    d = (s_neg - s_pos[:, None]).double()
    srt = torch.sort(d, dim=1, descending=True).values
    n = srt.shape[1]
    r = ranks.long().clamp(0, n)
    pad = torch.full((srt.shape[0], 1), -math.inf, dtype=srt.dtype, device=srt.device)
    ext = torch.cat([torch.full_like(pad, math.inf), srt, pad], dim=1)  # ext[:, j] = j-th
    need_above = -ext.gather(1, r[:, None])[:, 0]  # r-th highest >= -t
    need_below = ext.gather(1, (r + 1)[:, None])[:, 0]  # (r+1)-th <= t
    t = torch.clamp(torch.maximum(need_above, need_below), min=0.0)
    scale = torch.median(d.abs())
    return float(t.max() / scale)


def metrics_from_scores(s_pos, s_neg, ks=tuple(range(5, 21))):
    """HR@k, NDCG@k (k = 5..20) and AUC from each user's scores: its rank
    is the count of negatives scored above the positive (ties favour the
    positive), its AUC the share scored below it."""
    r = (s_neg > s_pos[:, None]).sum(1).double()
    kk = torch.tensor(ks, dtype=torch.float64, device=r.device)
    hit = (r[:, None] < kk[None, :]).double()
    ndcg = hit / torch.log2(r + 2.0)[:, None]
    auc = (s_neg < s_pos[:, None]).double().mean(1)
    return torch.cat([hit.mean(0), ndcg.mean(0), auc.mean()[None]])
