"""Window driver of a training cell: ``trainer.train_step`` over the feed.

Set-up makes the weights from the seed, builds the program's model and
optimizer once, and drives that same object through the traffic's first
``check_steps`` steps by the window's own call and feed; the batches the
program builds are recorded there (a pass-through around the trainer's
``_build_batch``), with the optimizer's state after step 1 and the weights
after the last.  The window then runs steps back to back with no host
sync, a CUDA event after each, until ``--seconds`` have passed, and ends
with a synchronise.  A traced run profiles ``profile_steps`` steps from
step ``profile_after`` of the window.
"""

from __future__ import annotations

import time
import types

import torch

from . import weights
from .window import Feed, Marks, SliceControl


def run(env, seed, seconds, trace, t_start):
    tr, dev, cfg, traffic = env.trainer, env.device, env.config, env.traffic
    gen = torch.Generator(device=dev).manual_seed(seed)
    leaves = weights.make_leaves(cfg["model"], env.hin.num_nodes, env.steps_per_channel,
                                 gen, dev)
    p0 = {k: v.detach().cpu().clone() for k, v in leaves.items()}
    params = weights.program_model(env.model_cls, leaves, env.steps_per_channel)
    opt = tr.optimizer(params)
    beta1 = opt.param_groups[0]["betas"][0]
    feed = Feed(tr.n_rows, cfg["train"]["batch_size"], gen)

    batches, rows, masks, losses = [], [], [], []
    build = tr._build_batch

    def recording(r, generator):
        batch = build(r, generator)
        batches.append(batch.clone())
        return batch

    tr._build_batch = recording
    try:
        for t in range(traffic["check_steps"]):
            r, m, _ = feed.next()
            losses.append(tr.train_step(params, opt, r, m, gen))
            rows.append(r.clone())
            masks.append(m.clone())
            if t == 0:  # an optimizer that kept no moment took nothing
                taken1 = {n: (opt.state[p].get("exp_avg", torch.zeros_like(p))
                              / (1.0 - beta1)).cpu()
                          for n, p in params.named_parameters()}
    finally:
        del tr._build_batch
    record = types.SimpleNamespace(
        p0=p0, batches=batches, rows=rows, masks=masks,
        losses=[float(x) for x in losses], taken1=taken1,
        final={n: p.detach().cpu().clone() for n, p in params.named_parameters()})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    setup_s = time.perf_counter() - t_start
    marks = Marks(dev)
    sl = SliceControl(dev, trace, traffic["profile_after"], traffic["profile_steps"])
    issue, window_losses, reals = [], [], []
    i = 0
    marks.mark()
    t0 = time.perf_counter()
    while True:
        sl.before(i)
        r, m, real = feed.next()
        h0 = time.perf_counter()
        window_losses.append(tr.train_step(params, opt, r, m, gen))
        issue.append(time.perf_counter() - h0)
        marks.mark()
        sl.after_unit(i)
        reals.append(real)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sl.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    intervals = marks.intervals_ms()
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    # a slice's bounds synchronise: its steps and the step after it are
    # left out of the host spans and of the tail
    skip = sl.inside | {max(sl.inside) + 1} if sl.inside else set()
    readings = types.SimpleNamespace(
        kind="train", setup_s=setup_s, window_s=window_s, units=i, work=sum(reals),
        failed=failed, intervals_ms=[x for j, x in enumerate(intervals) if j not in skip],
        interval_work=[x for j, x in enumerate(reals) if j not in skip],
        issue_s=[x for j, x in enumerate(issue) if j not in skip], slice=sl)
    state = types.SimpleNamespace(params=params, opt=opt)
    return readings, record, state
