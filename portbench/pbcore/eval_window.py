"""Window driver of an eval cell: ``trainer.evaluate`` back to back.

Set-up makes the weights from the seed and runs ``warmup_passes`` passes.
Each pass of the window gets a fresh generator seeded from (seed, pass)
and ranks every test user's held-out item against the negatives it
draws; its HR, NDCG and AUC are read on the host before the next pass
starts.  Passes 0 and k (k drawn from the seed in [1, check_span]; the
last pass where the window ended before k) are kept for the check with
their ranks; their negatives are drawn again after the window by the
traffic's ``negatives`` function from the same generator seed.
"""

from __future__ import annotations

import random
import time
import types

import torch

from . import weights
from .setup import resolve
from .window import SliceControl


def pass_seed(seed, i):
    return (seed * 1_000_003 + i + 1) % (1 << 62)


def _read(res):
    """The pass's HR[16], NDCG[16] and AUC on the host."""
    return torch.cat([res["HR"], res["NDCG"], res["AUC"].reshape(1)]).double().cpu()


def run(env, seed, seconds, trace, t_start):
    tr, dev, cfg, traffic = env.trainer, env.device, env.config, env.traffic
    gen = torch.Generator(device=dev).manual_seed(seed)
    leaves = weights.make_leaves(cfg["model"], env.hin.num_nodes, env.steps_per_channel,
                                 gen, dev)
    p0 = {k: v.detach().cpu().clone() for k, v in leaves.items()}
    params = weights.program_model(env.model_cls, leaves, env.steps_per_channel)

    def one_pass(i):
        return tr.evaluate(params, torch.Generator(device=dev).manual_seed(pass_seed(seed, i)))

    for j in range(traffic["warmup_passes"]):
        _read(one_pass(-1 - j))
    num_users = int(tr.tables.test_users.numel())
    k = random.Random(seed).randint(1, traffic["check_span"])

    setup_s = time.perf_counter() - t_start
    sl = SliceControl(dev, trace, traffic["profile_after"], traffic["profile_passes"])
    kept, issue, spans, failed, i = {}, [], [], 0, 0
    t0 = time.perf_counter()
    while True:
        sl.before(i)
        h0 = time.perf_counter()
        res = one_pass(i)
        issue.append(time.perf_counter() - h0)
        vals = _read(res)
        spans.append(time.perf_counter() - h0)
        sl.after_unit(i)
        failed += int(not bool(torch.isfinite(vals).all()))
        if i in (0, k):
            kept[i] = (res["ranks"], vals)
        last = (i, res["ranks"], vals)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sl.close()
    window_s = time.perf_counter() - t0
    if k not in kept:
        kept[last[0]] = last[1:]
    sampler = resolve(traffic["negatives"])
    passes = []
    for j, (ranks, vals) in sorted(kept.items()):
        g = torch.Generator(device=dev).manual_seed(pass_seed(seed, j))
        neg = sampler(g, tr.tables, cfg["train"]["num_neg_candidates"])
        passes.append(types.SimpleNamespace(index=j, ranks=ranks, vals=vals, neg=neg))
    skip = sl.inside
    readings = types.SimpleNamespace(
        kind="eval", setup_s=setup_s, window_s=window_s, units=i, work=i * num_users,
        failed=failed, intervals_ms=None, num_users=num_users,
        issue_s=[x for j, x in enumerate(issue) if j not in skip],
        pass_s=[x for j, x in enumerate(spans) if j not in skip], slice=sl)
    record = types.SimpleNamespace(p0=p0, passes=passes)
    state = types.SimpleNamespace(params=params)
    return readings, record, state
