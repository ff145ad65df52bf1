#!/usr/bin/env python3
"""Chip smoke of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi); no CUDA device
   means exit 2 and no result.
2. Builds every CUDA kernel of the port from csrc/ with nvcc (sm_90a) and
   prints ptxas's register / spill report.
3. Builds the flagship exactly as bench.py:42-59 does, with the port's
   builders: the synthetic ml-latest-small HIN (seed 7), PEAGAT,
   entity-aware, 9 two-step metapath channels, emb 64 -> hidden 64 -> repr
   16, BPR with 4 'unseen' negatives, batch 1024, Adam lr 1e-3 and L2 1e-3;
   one PEATrainer per transport (f32, bf16) on the card.
4. Kernel phase, per kernel and transport, at the shapes the flagship's plan
   gives it (flash_gat_fwd / flash_gat_bwd: the step-1 union graph, kz 64;
   batch_gat_fwd / batch_gat_bwd: the step-2 i2u share of 7 channels and
   u2i share of 2, kz 16), on random inputs from a numpy seed (the
   backwards on the forward kernel's stats of the same inputs and a random
   output cotangent): the largest error against the plain PyTorch version
   on the same card tensors (<= 1e-5 of the largest value in both
   transports: the two round at the same points and differ only in the
   order the atomics add, so a lost bf16 rounding point, ~1e-3, fails), the
   kernel's and the plain version's device time, and the bound (bytes read
   once + written once over 3.35 TB/s, or f32 operations over 67 TFLOP/s,
   whichever is larger).
5. Slice phase, per transport: init(2020), then PEATrainer.evaluate -- the
   hybrid GAT forward, the pair scorer, the 99-negative HR/NDCG/AUC -- with
   every kernel's launch count set to 0 just before and read just after
   (1 flash_gat_fwd and 2 batch_gat_fwd launches per eval, no backward);
   the cached representation against the same forward on a CPU copy (f32
   <= 1e-4 of the largest value; bf16 <= 2e-2, where a last-bit difference
   in a step-1 output can move a bf16 rounding of step 2's input); eval
   wall time and its device breakdown.
6. Training phase, per transport, the path PEATrainer.run_epoch at full
   width and depth: one step's launch counts (1 / 2 / 1 / 2 of
   flash_gat_fwd / batch_gat_fwd / flash_gat_bwd / batch_gat_bwd); one
   step's loss and every parameter gradient against the same step on a CPU
   copy (the plain path; see KINK_TOL); a warm-up epoch, then a timed
   epoch with the counts set to 0 before and read after (281 / 562 / 281 /
   562), printed as train examples/s and step ms; the second epoch's mean
   loss below the first; HR@10 after; one profiled step.
7. Prints the kernels' JSON line (a forward's launches are the eval's, a
   backward's the timed epoch's), then {"ok": true, "device": {...}} last.

Any failed check raises: the exit code is then nonzero and no result line
is printed.  Imports nothing of JAX.
"""

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM f32, outside the tensor cores
KERNEL_TOL = 1e-5
FORWARD_TOL = {"f32": 1e-4, "bf16": 2e-2}
# One step's gradients are discontinuous where a ReLU or leaky-ReLU input
# sits at 0: the card's atomics sum in another order than the CPU, which
# can flip one such input and move that node's whole contribution (one
# channel's step-1 leaves by 1.7e-2 of their largest value, measured in f32
# at the flagship).  The median leaf is held to FORWARD_TOL, every leaf to
# this.
KINK_TOL = 5e-2
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel_err(got, want):
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def device_ms(fn, reps=30, batches=2):
    """Median device time of one fn() call, by CUDA events around each call.
    A long sleep kernel goes first so the host enqueues every call while
    the card is busy: the calls then run back to back and the events time
    the card, not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        torch.cuda._sleep(100_000_000)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        ev[0].record()
        for i in range(reps):
            fn()
            ev[i + 1].record()
        torch.cuda.synchronize()
        times += [ev[i].elapsed_time(ev[i + 1]) for i in range(reps)]
    return statistics.median(times)


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def build_flagship():
    from graph_recsys_benchmark_tpu_torch.data import build_mlsmall_hin, synthetic_mlsmall_raw
    from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

    movies, ratings, tagging = synthetic_mlsmall_raw(
        seed=7, num_users=600, num_items=900,
        min_ratings_per_user=40, max_ratings_per_user=200,
        num_directors=120, num_actors=320, num_writers=160,
        num_tags=180, tagging_rows=3000,
    )
    hin = build_mlsmall_hin(movies, ratings, tagging, num_core=10, num_feat_core=5)
    cfg = PEAConfig(
        conv="gat", num_nodes=hin.num_nodes, meta_path_steps=(2,) * 9,
        emb_dim=64, hidden_size=64, repr_dim=16,
    )
    trainers = {
        t: PEATrainer(hin, cfg, TrainConfig(), device="cuda", transport=t)
        for t in ("f32", "bf16")
    }
    return hin, cfg, trainers


def bwd_stats(acc, mhat, n_ch, kz, t_dtype, g):
    """The backward's stat inputs from a forward accumulator, as the
    autograd Functions build them: gtab [N, n_ch*(kz+1)] = bands
    [round_T(g) | sum g*out], logden = m^ + log(s + 1e-16)."""
    num_rows = acc.shape[0]
    acc_b = acc.view(num_rows, n_ch, kz + 1)
    out = acc_b[:, :, :kz] / (acc_b[:, :, kz:] + 1e-16)
    gtab = torch.cat([g.to(t_dtype).float(), (g * out).sum(dim=2, keepdim=True)], dim=2)
    logden = mhat.view(n_ch, num_rows) + torch.log(acc_b[:, :, kz].t() + 1e-16)
    return gtab.reshape(num_rows, -1).contiguous(), logden.contiguous()


def check_kernel(name, transport, got, want):
    """Largest abs error of a kernel's outputs against its plain version;
    fails past KERNEL_TOL of the largest value."""
    torch.cuda.synchronize()
    worst = (0.0, 0.0)
    for a, b in zip(got, want):
        check(a.shape == b.shape, f"{name}: shape {tuple(a.shape)} vs {tuple(b.shape)}")
        check(bool(torch.isfinite(a).all()), f"{name} {transport}: non-finite output")
        worst = max(worst, rel_err(a, b), key=lambda r: r[1])
    check(worst[1] <= KERNEL_TOL,
          f"{name} {transport}: relative error {worst[1]} > {KERNEL_TOL}")
    return worst


def kernel_phase(plan, num_nodes):
    """Each kernel vs its plain version at the plan's shapes, per transport:
    the forwards on random tables, the backwards on the forward kernel's
    stats of the same tables and a random output cotangent."""
    from graph_recsys_benchmark_tpu_torch.ops import batch_gat as bg
    from graph_recsys_benchmark_tpu_torch.ops import flash_gat as fg

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    (_, union, rest), (shares, _, _) = plan.steps
    n_v, kz1 = len(rest) * num_nodes, 64
    e_union = union.num_edges
    results = {}
    for transport, t_dtype in TDT.items():
        itemsize = torch.finfo(t_dtype).bits // 8
        # ---- flash_gat_fwd / flash_gat_bwd on the step-1 union graph
        table = randn(n_v, kz1 + 1).to(t_dtype)  # row-major [z | a_src]
        adst_r, mhat = fg.bound_shift(randn(n_v), table[:, kz1], 0.2, t_dtype)
        args = (table, adst_r, mhat, union.src, union.dst, n_v, kz1)
        acc = fg.flash_gat_fwd(*args)
        err, rel = check_kernel("flash_gat_fwd", transport, [acc],
                                [fg.flash_gat_fwd_plain(*args)])
        # the bound counts what the work needs: each node's [z | a_src]
        # and the real edges' ids (not the padding edges)
        nbytes = (n_v * (kz1 + 1) * itemsize + 2 * n_v * 4 + e_union * 8
                  + n_v * (kz1 + 1) * 4)
        flops = e_union * (2 * (kz1 + 1) + 6)
        b_ms, b_by = bound_ms(nbytes, flops)
        results[("flash_fwd", transport)] = dict(
            max_abs_err=err,
            ms=device_ms(lambda: fg.flash_gat_fwd(*args)),
            plain_ms=device_ms(lambda: fg.flash_gat_fwd_plain(*args), reps=10),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        )
        print(f"flash_gat_fwd {transport}: rows {n_v} kz {kz1} edges {e_union} "
              f"(padded {union.dst.numel()}) rel_err {rel:.3e} bytes = [z | a_src] "
              f"{n_v * (kz1 + 1)}x{itemsize} + a_dst,m^ {2 * n_v}x4 + src,dst "
              f"{e_union}x8 + acc {n_v * (kz1 + 1)}x4 = {nbytes}", flush=True)

        gtab, logden = bwd_stats(acc, mhat, 1, kz1, t_dtype, randn(n_v, 1, kz1))
        bargs = (table, gtab, logden[0], adst_r, union.src, union.dst, n_v, kz1)
        err, rel = check_kernel("flash_gat_bwd", transport, fg.flash_gat_bwd(*bargs),
                                fg.flash_gat_bwd_plain(*bargs))
        # reads each node's [z | a_src] and stat row [g | gout], logden and
        # a_dst, the real edges' ids; writes dpk [dz | da_src] and da_dst
        nbytes = (n_v * (kz1 + 1) * (itemsize + 4) + 2 * n_v * 4 + e_union * 8
                  + n_v * (kz1 + 1) * 4 + n_v * 4)
        flops = e_union * (4 * kz1 + 14)
        b_ms, b_by = bound_ms(nbytes, flops)
        results[("flash_bwd", transport)] = dict(
            max_abs_err=err,
            ms=device_ms(lambda: fg.flash_gat_bwd(*bargs)),
            plain_ms=device_ms(lambda: fg.flash_gat_bwd_plain(*bargs), reps=10),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        )
        print(f"flash_gat_bwd {transport}: rows {n_v} kz {kz1} edges {e_union} "
              f"rel_err {rel:.3e} bytes = [z | a_src] {n_v * (kz1 + 1)}x{itemsize} + "
              f"[g | gout] {n_v * (kz1 + 1)}x4 + logden,a_dst {2 * n_v}x4 + src,dst "
              f"{e_union}x8 + dpk {n_v * (kz1 + 1)}x4 + da_dst {n_v}x4 = {nbytes}",
              flush=True)

        # ---- batch_gat_fwd / batch_gat_bwd on the step-2 shares (one entry
        # each: both calls)
        aggs = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0,
                        flops=0) for k in ("batch_fwd", "batch_bwd")}
        for g, chans in shares:
            n_ch, kz2 = len(chans), 16
            tab, ad, mh = bg._pack_tables(randn(n_ch, num_nodes, kz2), randn(n_ch, num_nodes),
                                          randn(n_ch, num_nodes), num_nodes, kz2, n_ch, 0.2,
                                          t_dtype)
            fargs = (tab, ad, mh, g.src, g.dst, num_nodes, kz2)
            acc = bg.batch_gat_fwd(*fargs)
            gtab, logden = bwd_stats(acc, mh, n_ch, kz2, t_dtype,
                                     randn(num_nodes, n_ch, kz2))
            bargs = (tab, gtab, logden, ad, g.src, g.dst, num_nodes, kz2)
            for key, fn, plain, a, nbytes, flops in (
                ("batch_fwd", bg.batch_gat_fwd, bg.batch_gat_fwd_plain, fargs,
                 tab.numel() * itemsize + 2 * ad.numel() * 4 + g.num_edges * 8
                 + tab.numel() * 4,
                 g.num_edges * n_ch * (2 * (kz2 + 1) + 6)),
                ("batch_bwd", bg.batch_gat_bwd, bg.batch_gat_bwd_plain, bargs,
                 tab.numel() * (itemsize + 4) + 2 * ad.numel() * 4 + g.num_edges * 8
                 + tab.numel() * 4 + ad.numel() * 4,
                 g.num_edges * n_ch * (4 * kz2 + 14)),
            ):
                got = fn(*a)
                err, rel = check_kernel(fn.__name__, transport,
                                        got if isinstance(got, tuple) else [got],
                                        plain(*a) if key == "batch_bwd" else [plain(*a)])
                ms = device_ms(lambda: fn(*a))
                plain_ms = device_ms(lambda: plain(*a), reps=10)
                print(f"{fn.__name__} {transport}: n_ch {n_ch} rows {num_nodes} kz {kz2} "
                      f"edges {g.num_edges} (padded {g.dst.numel()}) rel_err {rel:.3e} "
                      f"ms {ms:.4f} plain_ms {plain_ms:.4f} bytes {nbytes} flops {flops}",
                      flush=True)
                agg = aggs[key]
                agg["max_abs_err"] = max(agg["max_abs_err"], err)
                agg["ms"] += ms
                agg["plain_ms"] += plain_ms
                agg["bound_ms"] += bound_ms(nbytes, flops)[0]
                agg["bytes"] += nbytes
                agg["flops"] += flops
        for key, agg in aggs.items():
            agg["bound_by"] = bound_ms(agg.pop("bytes"), agg.pop("flops"))[1]
            agg["library_ms"] = None
            results[(key, transport)] = agg
    return results


def _counters():
    from graph_recsys_benchmark_tpu_torch.ops import batch_gat as bg
    from graph_recsys_benchmark_tpu_torch.ops import flash_gat as fg

    return {"flash_fwd": fg.flash_gat_fwd, "batch_fwd": bg.batch_gat_fwd,
            "flash_bwd": fg.flash_gat_bwd, "batch_bwd": bg.batch_gat_bwd}


def reset_launches():
    for fn in _counters().values():
        fn.launches = 0


def read_launches():
    return {k: fn.launches for k, fn in _counters().items()}


def slice_phase(cfg, trainers):
    from graph_recsys_benchmark_tpu_torch.models.pea import pea_forward

    out = {}
    for transport, trainer in trainers.items():
        params = trainer.init(2020)
        reset_launches()
        res = trainer.evaluate(params, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        launches = read_launches()
        check(launches == {"flash_fwd": 1, "batch_fwd": 2, "flash_bwd": 0, "batch_bwd": 0},
              f"{transport} eval: launches {launches}, expected flash_fwd 1, batch_fwd 2")
        check(res["HR"].shape == (16,) and res["NDCG"].shape == (16,), "metric shapes")
        for k in ("HR", "NDCG", "AUC", "eval_loss"):
            check(bool(torch.isfinite(res[k]).all()), f"{transport} eval: {k} not finite")
        auc = float(res["AUC"])
        check(0.0 <= auc <= 1.0, f"AUC {auc}")

        with torch.no_grad():
            rep = trainer.eval_forward(params)
            cpu_rep = pea_forward(copy.deepcopy(params).cpu(), trainer.graphs.to("cpu"),
                                  cfg, transport=transport)
        check(rep.shape == (cfg.num_nodes, cfg.repr_dim), f"repr shape {tuple(rep.shape)}")
        check(bool(torch.isfinite(rep).all()), "repr not finite")
        err, rel = rel_err(rep.cpu(), cpu_rep)
        check(rel <= FORWARD_TOL[transport],
              f"{transport} forward vs CPU copy: relative error {rel} > {FORWARD_TOL[transport]}")
        out[transport] = dict(launches=launches, params=params)
        print(f"slice {transport}: launches {launches} HR@10 {float(res['HR'][5]):.4f} "
              f"NDCG@10 {float(res['NDCG'][5]):.4f} AUC {auc:.4f} "
              f"eval_loss {float(res['eval_loss']):.4f} "
              f"repr vs CPU: max abs {err:.3e} rel {rel:.3e}", flush=True)

    # eval wall time, the two transports in turns (f32, bf16, bf16, f32, ...)
    walls = {t: [] for t in trainers}
    for i in range(10):
        for t in (("f32", "bf16") if i % 2 == 0 else ("bf16", "f32")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainers[t].evaluate(out[t]["params"],
                                 torch.Generator(device="cuda").manual_seed(i + 1))
            torch.cuda.synchronize()
            walls[t].append((time.perf_counter() - t0) * 1e3)
    for t, ws in walls.items():
        print(f"eval wall ms {t}: median {statistics.median(ws):.4f} "
              f"runs {[round(w, 4) for w in ws]}", flush=True)
        device_breakdown(
            lambda: trainers[t].evaluate(out[t]["params"],
                                         torch.Generator(device="cuda").manual_seed(99)),
            f"eval {t}", statistics.median(ws))
    return out


def device_breakdown(fn, label, wall_ms):
    """Device time of fn() by kernel (torch.profiler, CUPTI) against the
    unprofiled median wall of the same work: the card's busy share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # user annotations (the optimizer's step and zero_grad ranges) span
    # kernels that are listed on their own: count the kernels only
    rows = [(getattr(e, "self_device_time_total", 0.0), e.count, e.key)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(r[0] for r in rows)
    n_kernels = sum(r[1] for r in rows)
    print(f"{label} device time: {busy_us / 1e3:.4f} ms in {n_kernels} device ops "
          f"= {busy_us / 1e3 / wall_ms:.3f} of the {wall_ms:.4f} ms median wall", flush=True)
    for us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  {us:9.1f} us  x{count:<3d} {key[:90]}", flush=True)


def train_phase(hin, cfg, trainers):
    """Per transport, the training path PEATrainer.run_epoch at full width
    and depth: one step's launch counts, one step's loss and gradients
    against a CPU copy, a warm-up epoch and a timed epoch (counts read over
    it), the loss falling between them, HR@10 after, and one profiled step."""
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer

    out = {}
    for transport, trainer in trainers.items():
        bs = trainer.tcfg.batch_size
        # ---- one step's launch counts, through the main path's step
        params = trainer.init(2020)
        opt = trainer.optimizer(params)
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows = torch.arange(bs, device="cuda")
        mask = torch.ones(bs, device="cuda")
        reset_launches()
        trainer.train_step(params, opt, rows, mask, gen)
        torch.cuda.synchronize()
        step_launches = read_launches()
        check(step_launches == {"flash_fwd": 1, "batch_fwd": 2, "flash_bwd": 1, "batch_bwd": 2},
              f"{transport} train step: launches {step_launches}")

        # ---- one step's loss and every gradient, card vs a CPU copy, off
        # the init regime (tests/test_torch_train_slice.py:_trained_like:
        # at init the user representations' gradients vanish to float noise)
        params = trainer.init(2020)
        with torch.no_grad():
            params.x.mul_(10.0)
            params.fc1["b"].mul_(0.1)
        cpu_params = copy.deepcopy(params).cpu()
        cpu = PEATrainer(hin, cfg, trainer.tcfg, device="cpu", transport=transport)
        cgen = torch.Generator().manual_seed(1)
        batch = cpu._build_batch(torch.randperm(cpu.n_rows, generator=cgen)[:bs], cgen)
        rmask = (torch.arange(bs) < bs - 100).float()  # a partial batch
        loss = trainer.batch_loss(params, batch.cuda(), rmask.cuda())
        loss.backward()
        cpu_loss = cpu.batch_loss(cpu_params, batch, rmask)
        cpu_loss.backward()
        torch.cuda.synchronize()
        tol = FORWARD_TOL[transport]
        _, rel = rel_err(loss.detach().cpu(), cpu_loss.detach())
        check(rel <= tol, f"{transport} step loss vs CPU: relative error {rel} > {tol}")
        errs = []
        for (name, p), cp in zip(params.named_parameters(), cpu_params.parameters()):
            check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                  f"{transport} grad {name}: missing or not finite")
            if cp.grad.any():
                errs.append((rel_err(p.grad.cpu(), cp.grad)[1], name))
            else:  # fc2's bias cancels in pos - neg, on both devices
                check(not p.grad.any(), f"{transport} grad {name}: expected exact zeros")
        errs.sort()
        median, worst = errs[len(errs) // 2], errs[-1]
        check(median[0] <= tol and worst[0] <= KINK_TOL,
              f"{transport} grads vs CPU: median {median} > {tol} or worst {worst} > {KINK_TOL}")
        print(f"train {transport}: one step launches {step_launches}; loss "
              f"{float(loss.detach()):.6f} vs CPU {float(cpu_loss.detach()):.6f} (rel "
              f"{rel:.3e}); gradients vs CPU: median {median[1]} rel {median[0]:.3e}, worst "
              f"{worst[1]} rel {worst[0]:.3e}, {sum(e > tol for e, _ in errs)} of {len(errs)} "
              f"over {tol}", flush=True)

        # ---- a warm-up epoch, then a timed epoch
        params = trainer.init(2020)
        opt = trainer.optimizer(params)
        gen = torch.Generator(device="cuda").manual_seed(7)
        secs, losses = [], []
        for epoch in range(2):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(trainer.run_epoch(params, opt, gen)))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = read_launches()
        n = trainer.num_batches
        check(launches == {"flash_fwd": n, "batch_fwd": 2 * n, "flash_bwd": n,
                           "batch_bwd": 2 * n},
              f"{transport} epoch: launches {launches}, expected {n}/{2 * n}/{n}/{2 * n}")
        check(all(np.isfinite(losses)), f"{transport}: epoch losses {losses}")
        check(losses[1] < losses[0],
              f"{transport}: second epoch mean loss {losses[1]} not below the first {losses[0]}")
        res = trainer.evaluate(params, torch.Generator(device="cuda").manual_seed(0))
        step_ms = secs[1] / n * 1e3
        print(f"train {transport}: {trainer.n_rows} rows, {n} steps of {bs}; epoch mean loss "
              f"{losses[0]:.6f} -> {losses[1]:.6f}; epoch s {secs[0]:.3f} (warm-up) "
              f"{secs[1]:.3f} (timed); train examples/s {trainer.n_rows / secs[1]:.1f}; "
              f"step ms {step_ms:.4f}; launches over the timed epoch {launches}; "
              f"HR@10 after 2 epochs {float(res['HR'][5]):.4f} "
              f"NDCG@10 {float(res['NDCG'][5]):.4f} AUC {float(res['AUC']):.4f}", flush=True)
        rows = torch.arange(bs, device="cuda")
        device_breakdown(lambda: trainer.train_step(params, opt, rows, mask, gen),
                         f"train step {transport}", step_ms)
        out[transport] = dict(launches=launches, step_launches=step_launches)
    return out


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)

    sys.path.insert(0, HERE)
    from graph_recsys_benchmark_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    logs = _cuda.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        print(f"--- nvcc -Xptxas -v: {name}\n{log.strip()}", flush=True)

    t0 = time.perf_counter()
    hin, cfg, trainers = build_flagship()
    plan = trainers["f32"].graphs
    (b1, union, rest), (shares, u2, _) = plan.steps
    check(len(b1) == 0 and len(rest) == 9 and u2 is None, "step-1 plan: expected one 9-channel union")
    check([c for _, c in shares] == [(0, 2, 3, 4, 5, 6, 7), (1, 8)],
          f"step-2 plan: shares {[c for _, c in shares]}")
    print(f"flagship: {hin.num_nodes} nodes, {hin.train_pos.shape[0]} train interactions, "
          f"{hin.candidates.cand.shape[0]} test users (candidates {hin.candidates.cand.shape}); "
          f"step 1 union {len(rest) * hin.num_nodes} rows {union.num_edges} edges "
          f"(padded {union.dst.numel()}); step 2 shares "
          f"{[(c, g.num_edges, g.dst.numel()) for g, c in shares]}; host build "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    kres = kernel_phase(plan, hin.num_nodes)
    sres = slice_phase(cfg, trainers)
    tres = train_phase(hin, cfg, trainers)

    repo = "graph_recsys_benchmark_tpu"
    csrc = "graph_recsys_benchmark_tpu_torch/csrc"
    kernels = []
    for (kind, transport), r in kres.items():
        if kind == "flash_fwd":
            name = f"flash_gat_fwd ({transport}; union kz 64)"
            # at the flagship the JAX package runs K1 in bf16 and K12
            # (bound shift) in f32 (its VMEM gate, flash_gat.py:722-731)
            replaces = f"{repo}/ops/flash_gat.py:" + ("479" if transport == "bf16" else "129")
        elif kind == "batch_fwd":
            name = f"batch_gat_fwd ({transport}; n_ch 7+2, kz 16)"
            replaces = f"{repo}/ops/batch_gat.py:176"
        elif kind == "flash_bwd":
            name = f"flash_gat_bwd ({transport}; union kz 64)"
            replaces = f"{repo}/ops/flash_gat.py:829"
        else:
            name = f"batch_gat_bwd ({transport}; n_ch 7+2, kz 16)"
            replaces = f"{repo}/ops/batch_gat.py:249"
        # a forward's launches are the eval's, a backward's the timed epoch's
        runs = sres if kind.endswith("fwd") else tres
        kernels.append(dict(
            name=name, route="cuda",
            source=f"{csrc}/gat_{'fwd' if kind.endswith('fwd') else 'bwd'}.cu",
            replaces=replaces,
            launches=runs[transport]["launches"][kind], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
