"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (reference.py) on the same inputs.

Training cells (the first ``check_steps`` steps of the object the window
then drives, against the reference in float64):
  batch_violations  rows of the recorded batches that break their sampling
                    rule (exact: 0)
  loss_gap          max over the steps of |loss - reference| / |reference|
  grad1_gap         the first gradient as Adam took it (its first moment
                    after step 1 over 1 - beta1), at the median leaf: the gap
                    between the program's norm and the reference's over the
                    larger of the reference leaf's norm and the median leaf's
                    (the worst leaf's goes to the notes: where round-off
                    tips a ReLU near-tie, a small leaf such as a bias moves
                    by up to 3e-2)
  change_gap        the same gap for the weights' change over the steps, at
                    the median leaf (the worst leaf's goes to the notes: a
                    step-2 attention vector, whose destination half has a
                    gradient near round-off, swings from seed to seed), of
                    the leaves whose reference loss gradient at step 1 is at
                    least 1e-3 of the median leaf's (the rest move under
                    Adam by round-off alone)
  window_nonfinite  steps of the window whose loss is not finite (0)
Eval cells (passes 0 and k of the window):
  negative_violations  drawn negatives outside the items or among the
                       user's train and test items (0)
  rank_gap          reference.rank_gap, worst pass
  metrics_gap       the pass's HR, NDCG and AUC against the reference's
                    from its own scores, worst value
  window_nonfinite  passes with a metric not finite (0)
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from . import reference as ref


def dataset_arrays(hin, device):
    """The dataset's arrays the reference reads, on `device`."""

    def t(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=torch.int64)

    ef = hin.entity_feats
    out = dict(train_pos=t(hin.train_pos), item_lo=int(hin.type_accs[hin.types[1]]),
               num_items=int(hin.num_nodes_dict[hin.types[1]]),
               user_lo=int(hin.type_accs[hin.types[0]]),
               test_users=t(hin.candidates.test_users),
               test_items=t(hin.candidates.test_items))
    if ef is not None:
        for f in ("item_feat", "item_feat_counts", "user_feat", "user_feat_counts",
                  "ent_lo", "ent_hi"):
            out[f] = t(getattr(ef, f))
    return out


def leaf_gaps(prog: dict, want: dict, names):
    """{leaf: |‖prog‖ - ‖want‖| / max(‖want‖, median leaf ‖want‖)}."""
    norms = {n: float(want[n].double().norm()) for n in names}
    med = statistics.median(norms.values())
    return {n: abs(float(prog[n].double().norm()) - norms[n]) / max(norms[n], med)
            for n in names}


def train_numbers(prog, want, grad1_want):
    """prog / want: (losses, taken1, final) of the program (or a stand-in)
    and of the reference; the change is taken from the same p0."""
    p0 = prog["p0"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"]))
    names = list(want["taken1"])
    g1 = leaf_gaps(prog["taken1"], want["taken1"], names)
    grad1_leaf = max(g1, key=g1.get)
    gnorm = {n: float(grad1_want[n].double().norm()) for n in names}
    med = statistics.median(gnorm.values())
    moved = [n for n in names if gnorm[n] >= 1e-3 * med]
    change = leaf_gaps({n: prog["final"][n] - p0[n] for n in moved},
                       {n: want["final"][n] - p0[n] for n in moved}, moved)
    worst = max(change, key=change.get)
    return ({"loss_gap": loss_gap, "grad1_gap": statistics.median(g1.values()),
             "change_gap": statistics.median(change.values())},
            {"grad1_worst_leaf": grad1_leaf, "grad1_worst_gap": g1[grad1_leaf],
             "change_worst_leaf": worst,
             "change_worst_gap": change[worst], "left_out": sorted(set(names) - set(moved))})


def reference_steps(env, record, arrays, precision="f32", mask_fn=None, scale=1.0):
    """The reference's losses, Adam-taken step-1 gradients, step-1 loss
    gradients and final weights over the recorded batches (optionally
    with the masks changed by `mask_fn` and the loss scaled: a planted
    fault).  The configuration's float32 is followed in float64: in
    float32 a ReLU input within round-off of 0 falls on either side with
    the order of a sum's atomic adds, and on some seeds that moves the
    median leaf's first gradient by 6e-5 to 5e-4 from one repeat to the
    next (PERF.md).  The TF32 control stays in float32."""
    cfg = env.config
    dtype = torch.float64 if precision == "f32" else torch.float32
    p0 = {n: v.to(dtype) for n, v in record.p0.items()}
    graphs = ref.build_graphs(env.hin.edge_index, cfg["metapaths"], env.hin.num_nodes,
                              env.device)
    masks = [m if mask_fn is None else mask_fn(m) for m in record.masks]
    model = dict(cfg["model"])
    if scale != 1.0:
        model["loss_scale"] = scale
    losses, grad1, taken1, final = ref.train_steps(
        p0, graphs, model, env.hin.num_nodes, record.batches, masks,
        cfg["train"]["lr"], cfg["train"]["weight_decay"], ref.Precision(precision),
        env.device)
    return {"p0": record.p0, "losses": losses, "taken1": taken1, "final": final}, grad1


def batch_violation_count(env, record, arrays):
    tcfg = env.config["train"]
    return sum(
        ref.batch_violations(b, r, arrays, tcfg["num_negative_samples"],
                             tcfg["sampling_strategy"], env.config["model"]["entity_aware"])
        for b, r in zip(record.batches, record.rows))


def program_steps(record):
    return {"p0": record.p0, "losses": record.losses, "taken1": record.taken1,
            "final": record.final}


def train_check(env, record, precision="f32"):
    arrays = dataset_arrays(env.hin, env.device)
    want, grad1 = reference_steps(env, record, arrays, precision)
    numbers, notes = train_numbers(program_steps(record), want, grad1)
    numbers["batch_violations"] = batch_violation_count(env, record, arrays)
    return numbers, notes


def seen_keys(arrays):
    """Sorted keys u_local * num_items + item_local of every user's train
    and test items."""
    n_items, ilo, ulo = arrays["num_items"], arrays["item_lo"], arrays["user_lo"]
    tp = arrays["train_pos"]
    keys = torch.cat([(tp[:, 0] - ulo) * n_items + (tp[:, 1] - ilo),
                      (arrays["test_users"] - ulo) * n_items + (arrays["test_items"] - ilo)])
    return torch.unique(keys)


def pass_scores(env, p0, arrays, negs, precision="f32", block=8192):
    """Reference scores of each test user's positive [U] and of its drawn
    negatives [U, C] for each of `negs`, from one reference forward."""
    cfg = env.config
    graphs = ref.build_graphs(env.hin.edge_index, cfg["metapaths"], env.hin.num_nodes,
                              env.device)
    prec = ref.Precision(precision)
    leaves = {k: v.to(env.device) for k, v in p0.items()}
    with torch.no_grad():
        rep = ref.forward(leaves, graphs, cfg["model"], env.hin.num_nodes, prec)
        users, pos = arrays["test_users"], arrays["test_items"]
        s_pos = torch.cat([ref.predict(leaves, rep, users[a:a + block], pos[a:a + block], prec)
                           for a in range(0, users.numel(), block)])
        out = []
        for neg in negs:
            c = neg.shape[1]
            rows = []
            for a in range(0, users.numel(), block):
                u = users[a:a + block].repeat_interleave(c)
                rows.append(ref.predict(leaves, rep, u, neg[a:a + block].reshape(-1).long(),
                                        prec).reshape(-1, c))
            out.append(torch.cat(rows))
    return s_pos, out


def eval_numbers(record, arrays, s_pos, s_negs):
    """The eval numbers of the recorded passes against reference scores."""
    keys = seen_keys(arrays)
    users_local = arrays["test_users"] - arrays["user_lo"]
    numbers = {"negative_violations": 0, "rank_gap": 0.0, "metrics_gap": 0.0}
    for p, s_neg in zip(record.passes, s_negs):
        numbers["negative_violations"] += ref.negative_violations(
            p.neg, users_local, keys, arrays["item_lo"], arrays["num_items"])
        numbers["rank_gap"] = max(numbers["rank_gap"], ref.rank_gap(p.ranks, s_pos, s_neg))
        want = ref.metrics_from_scores(s_pos, s_neg).cpu()
        numbers["metrics_gap"] = max(numbers["metrics_gap"],
                                     float((want - p.vals).abs().max()))
    return numbers


def eval_check(env, record, precision="f32"):
    arrays = dataset_arrays(env.hin, env.device)
    s_pos, s_negs = pass_scores(env, record.p0, arrays, [p.neg for p in record.passes],
                                precision)
    return (eval_numbers(record, arrays, s_pos, s_negs),
            {"passes": [p.index for p in record.passes]})
