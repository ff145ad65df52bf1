#!/usr/bin/env python3
"""Chip smoke of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi); no CUDA device
   means exit 2 and no result.
2. Builds every CUDA kernel of the port from csrc/ with nvcc (sm_90a) and
   prints ptxas's register / spill report.
3. Builds the flagship exactly as bench.py:42-59 does, with the port's
   builders: the synthetic ml-latest-small HIN (seed 7), entity-aware, 9
   two-step metapath channels, emb 64 -> hidden 64 -> repr 16, BPR with 4
   'unseen' negatives, batch 1024, Adam lr 1e-3 and L2 1e-3; one PEATrainer
   per conv (PEAGAT: the hybrid plan; PEAGCN, PEASage: one union graph a
   step) and transport (f32, bf16) on the card.
4. GAT kernel phase, per kernel and transport, at the shapes the flagship's
   plan gives it (flash_gat_fwd / flash_gat_bwd: the step-1 union graph, kz
   64; batch_gat_fwd / batch_gat_bwd: the step-2 i2u share of 7 channels
   and u2i share of 2, kz 16), on random inputs from a numpy seed (the
   backwards on the forward kernel's stats of the same inputs and a random
   output cotangent): the largest error against the plain PyTorch version
   on the same card tensors (<= 1e-5 of the largest value in both
   transports: the two round at the same points and differ only in the
   order the atomics add, so a lost bf16 rounding point, ~1e-3, fails), the
   kernel's and the plain version's device time, and the bound (bytes read
   once + written once over 3.35 TB/s, or f32 operations over 67 TFLOP/s,
   whichever is larger).  The forwards walk the graph's sort by dst
   (StepGraph.dst_perm / dst_sorted), the backwards its sort by source
   (src_perm / src_sorted); each graph's lines check that each walk is
   ids[perm] and give the mean edges a dst and a source take in the edges'
   own order and in the walk (print_runs, id_runs).
5. Edge kernel phase (edge_kernel_phase): sorted_segment_sum (K5),
   sorted_broadcast (K7) and localized_scatter_add (K6) at each of the
   PEAGCN and PEASage union graphs' shapes, per transport: error against
   the plain version (K7 bitwise; K5 and K6 each row within sum_bound of
   the float64 sums), device ms of the kernel, the
   plain version and one PyTorch library call of the same function, and
   the bound; K5 and K6 walk the union graph's sorted orders as the path
   does.  (300 columns: cli_phase d.)
6. PEAGAT eval phase, per transport: init(2020), then PEATrainer.evaluate --
   the hybrid GAT forward, the pair scorer, the 99-negative HR/NDCG/AUC --
   with every kernel's launch count set to 0 just before and read just
   after (1 flash_gat_fwd and 2 batch_gat_fwd launches per eval, nothing
   else); the cached representation against the same forward on a CPU copy
   (f32 <= 1e-4 of the largest value; bf16 <= 2e-2, where a last-bit
   difference in a step-1 output can move a bf16 rounding of step 2's
   input); eval wall time and its device breakdown.
7. PEAGAT training phase, per transport, the path PEATrainer.run_epoch at
   full width and depth: one step's launch counts (1 / 2 / 1 / 2 of
   flash_gat_fwd / batch_gat_fwd / flash_gat_bwd / batch_gat_bwd); one
   step's loss and every parameter gradient against the same step on a CPU
   copy (the plain path; see KINK_TOL); a warm-up epoch, then a timed
   epoch with the counts set to 0 before and read after (281 / 562 / 281 /
   562), printed as train examples/s and step ms; the second epoch's mean
   loss below the first; HR@10 after; one profiled step.
8. PEAGCN (two epochs) and PEASage (one epoch) phases (fused_phase), per
   transport: the eval's launches (K7 2, K5 2) and its forward against a
   CPU copy; one step's launches (K7 4, K5 2, K6 2) and its loss and
   gradients against a CPU copy; epochs with the counts read over the last
   (1,124 / 562 / 562), the loss falling over two epochs and HR@10 after
   them above the untrained 0.10; eval wall; a profiled step and eval.
9. Flash-GAT variant routes (ops/config.FlashGATMode), the last flagship
   phases.
   a. mode_kernel_phase, per transport at the step-1 union graph's shapes
      (15,210 rows, 169,155 edges, kz 64): gat_rowmax (K12-online pass 1,
      its m bitwise the plain version's), flash_gat_fwd_online (pass 2,
      the walk, <= KERNEL_TOL), flash_gat_bwd_glue (K13, on the walk by
      dst: each stored cotangent element within one unit of the
      transport's last place of the plain version's, padding rows exact
      zeros, da_dst row by row within sum_bound of the float64 sums of its
      plain version's terms), localized_scatter_add (K6) on K13's rows
      (sum_bound of the float64 sums of the same rows), flash_gat_bwd_onepass (K14, on the walk by
      source: dpk and da_dst row by row within sum_bound of the float64
      sums of its plain version's terms); device, plain, library ms and the
      bound of each.
   b. mode_slice_phase, per transport and non-default mode (online-fused,
      bound-glue, bound-onepass): a PEATrainer(..., flash_mode=...) against
      the default mode's on the same weights and batches: one batch's loss
      and gradients (FORWARD_TOL, the median leaf, KINK_TOL), 20 steps from
      init(2020) with the counts read over them (online: 1 gat_rowmax + 1
      flash_gat_fwd_online a forward; glue: 1 flash_gat_bwd_glue + 1 K6 a
      backward; onepass: 1 flash_gat_bwd_onepass), every step's loss and
      the forward after them (FORWARD_TOL), one eval's launches; step ms,
      train examples/s, a profiled step.
10. ML-25M phases (ml25m_*), PEAGAT at tools/bench_25m.py:41-58's full
   configuration: synthetic_ml25m_hin() (seed 0: 68,830 nodes, 2.13 M
   train interactions, 40,000 test users, rejection candidates), 13
   two-step channels (ml25m_metapath_edges), 64 -> 64 -> 16, entity-aware,
   batch 4,096, 'random' negatives, Adam; one PEATrainer per transport.
   a. Build: host seconds (out of every timed window), each distinct step
      graph's rows, edges and padded edges (for the streaming graphs also
      the busiest 128-row block by dst and by src and the largest
      degrees), the channel groups per step.
   b. Kernel checks at the path's own shapes, per transport: softmax_stats
      (K8) on each composed (loop-edge) graph with its block bounds, its
      max bitwise and each row's sum within sum_bound of the float64 sum
      (with each term's subtraction and expf error), its launches a call
      (1), and the busiest 128-row block alone (every other block's range
      empty: the time of the CTA that sets the call's); stream_gat_fwd /
      _bwd_dst / _bwd_src (K9, K10, K11) at the four streaming calls of a
      forward ((n_ch, kz) = (1, 64) on u2i and i2u, (7, 16) on i2u, (2,
      16) on u2i) on random tables, each against the float64 sums of its
      plain version's terms (<= 1e-5 of the largest value); device ms,
      plain ms, the byte or operation bound and, for K8, the library
      composition scatter_reduce_(amax) + index_add_(exp) (K9-K11 have
      none). Each a sum over one forward's calls.  K9, K10 and K11 are
      also timed, and checked, at pieces of 512 to 8,192 edges
      (STREAM_PIECES), and the build prints ptxas's registers and spills
      of the three and of K8 (ptxas_summary).
   b'. K7, K5 and K6 at the ML-25M step's own shapes, per transport
      (ml25m_edge_kernel_phase): one training step's calls of the three
      wrappers recorded (75, 45 and 15: the 15 composed convs' gathers,
      sums and backwards), each replayed against its plain version (K7
      bitwise, K5 and K6 within sum_bound of the float64 sums), and timed
      back to back as a step's sum beside the plain versions, the library
      calls (index_select, index_add_) and the byte bound; then per width
      group (the calls of one row width and dtype) the same replay's ms
      and its byte bound, and for K5 and K6 the kernels' time alone
      (sum_alone: without the zeroing of their outputs) and the mean edges
      an id takes in runs of the edge order, in a 32-edge window, in a
      2,048-edge chunk and in the call (id_runs).
   c. Training, per transport: one step's launch counts (K9 4, K8 15,
      K10 4, K11 4, K7 75, K5 45, K6 15, as the graphs' grouping predicts);
      one step's loss and every gradient against the same step with every
      kernel's plain version on the card (plain_on_card; the median leaf
      at FORWARD_TOL, every leaf at KINK_TOL; weights off the init regime);
      2 warm-up steps, then 8 timed steps on rows drawn uniformly, counts
      read over them, the loss finite; step ms, train examples/s, and a
      profiled step (device ms, busy share, the matrix products' shapes).
   d. One evaluation per transport: 40,000 users x (1 + 99) candidates in
      rejection mode, its launches (the forward's), its forward against
      the plain versions on the card, wall ms, HR@10, NDCG@10, AUC.
11. CLI phases (cli_phase), through the port's entry point cli.main in
   process, each call with every launch count set to 0 just before and
   read just after, in a temporary directory:
   a. the published recipe, `--model PEAGAT --dataset synthetic-ml
      --entity_aware true` at the CLI's defaults (5 runs x 30 epochs, batch
      1,024, f32): its launches against the hybrid plan's prediction (a
      step's forward and backward launches x steps an epoch x 150 epochs,
      plus a forward's x 155 evals), each run's initial and best HR@10 (the
      best above the initial), the overall HR@10 within HR_BAND (JAX
      0.3320 +- 0.05), NDCG@10, AUC, the wall and seconds an epoch;
   b. a --runs 1 call, then --runs 2 into the same run directory: run 1 is
      not trained again and run 2 is (its launches alone), run 1's summary
      row kept; run 2's latest checkpoint loads onto the card bitwise;
   c. bf16 with the metapath ablation and full-catalog ranking (1 run x 2
      epochs): its launches; evaluate_full on its checkpoint launches the
      forward's kernels and no more, and its ranks equal those over a CPU
      copy of the cached representation but for near ties (1e-5);
   d. PEAGCN at --hidden_size 300 per transport (K5 and K6 past MAX_COLS
      in two passes, K7 in one launch): launches against the prediction
      (K7 4, K5 3, K6 3 a step, K7 2, K5 3 an eval); then K5, K7 and K6 on
      that call's step-1 union graph at 300 columns, as in phase 5, with
      the seconds of the case;
   e. `python -m graph_recsys_benchmark_tpu_torch` as a subprocess, 1 run x
      1 epoch: exit 0 and the Overall line.
12. Prints the kernels' JSON line (a GAT forward's launches are the
   eval's, a GAT backward's the timed epoch's, an edge kernel's the last
   timed epoch of its path (at 300 columns 11d's CLI call: its epoch and
   the eval after it),
   K8-K11's and the ML-25M entries of K5-K7 the
   8 timed ML-25M steps, a variant route's forward its mode's eval and its
   backward its mode's 20 steps),
   then {"ok": true, "device": {...}} last.

Any failed check raises: the exit code is then nonzero and no result line
is printed.  Imports nothing of JAX.
"""

import contextlib
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM f32, outside the tensor cores
KERNEL_TOL = 1e-5
# f32 sums in atomic order against the same sums in float64
# (edge_kernel_phase, ml25m_kernel_phase) are held to sum_bound, row by
# row; SEG_TOL is only the share of the largest value they are reported in.
SEG_TOL = 1e-6
# unit roundoff of one f32 addition, plus one of the float64 reference's
U_SUM = 2.0 ** -24 + 2.0 ** -53
# the f32 atomics flush a subnormal result: at most this lost per addition
F32_TINY = 2.0 ** -126
# CUDA's expf is within 2 ulp (CUDA C Programming Guide, single-precision
# mathematical functions): at most 2^-22 of its value
EXPF_REL = 2.0 ** -22
FORWARD_TOL = {"f32": 1e-4, "bf16": 2e-2}
# One step's gradients are discontinuous where a ReLU or leaky-ReLU input
# sits at 0: the card's atomics sum in another order than the CPU, which
# can flip one such input and move that node's whole contribution (one
# channel's step-1 leaves by 1.7e-2 of their largest value, measured in f32
# at the flagship).  The median leaf is held to FORWARD_TOL, every leaf to
# this.
KINK_TOL = 5e-2
# The pair scorer's ReLU (pea_predict's fc1) is such a kink in every batch
# row: one row flipped there moves every leaf by that row's share of the
# batch, not by a rounding (PEAGCN f32 on the card: median leaf 1.47e-3 in
# one batch of 1,024).  kink_rows drops such rows from both sides of a
# comparison; more than this share of a batch fails.
KINK_ROW_SHARE = 0.01
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel_err(got, want):
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def sum_bound(terms, ids, n, term_err=None):
    """Per-row bound on |f32 sum - exact sum| of `terms` [E, ...] (float64,
    the values the kernel adds) by `ids` (ids >= n dropped), whatever the
    order of the additions: a row of k terms takes k - 1 roundings, each at
    most U_SUM of a partial sum no larger than sum |t|, so at most
    gamma_(k-1) * sum |t| (Higham, Accuracy and Stability of Numerical
    Algorithms, 2nd ed., eq. 4.4), plus a flushed subnormal per addition
    and, where given, each term's own error `term_err` before the sum."""
    from graph_recsys_benchmark_tpu_torch.ops.segment import segment_sum

    absum = segment_sum(terms.abs(), ids, n)
    k = torch.bincount(torch.clamp(ids.long(), max=n), minlength=n + 1)[:n].double()
    k = k.view((n,) + (1,) * (terms.dim() - 1))
    gamma = (k - 1).clamp(min=0) * U_SUM
    gamma = gamma / (1 - gamma)
    bound = gamma * absum + k * F32_TINY
    if term_err is not None:
        errsum = segment_sum(term_err, ids, n)
        bound = bound + errsum * (1 + gamma)
    return bound


def check_sum(name, got, exact, bound):
    """Every row of an f32 atomic sum within its sum_bound of the float64
    sum; returns the largest share of its bound that an error takes."""
    err = (got.double() - exact).abs()
    share = float((err / bound.clamp(min=1e-300)).max()) if err.numel() else 0.0
    check(bool((err <= bound).all()),
          f"{name}: an f32 sum is off the float64 sum by more than its rounding bound "
          f"(largest share {share:.3f})")
    return share


def leaf_errors(label, params, ref):
    """Every gradient leaf of `params` against the same leaf of `ref` (a
    model of the same layout, on any device), relative to the ref leaf's
    largest value, sorted; every gradient present and finite, and exact
    zeros where ref's are (fc2's bias cancels in pos - neg)."""
    errs = []
    for (name, p), r in zip(params.named_parameters(), ref.parameters()):
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"{label} grad {name}: missing or not finite")
        if r.grad.any():
            errs.append((rel_err(p.grad.to(r.grad.device), r.grad)[1], name))
        else:
            check(not p.grad.any(), f"{label} grad {name}: expected exact zeros")
    return sorted(errs)


def kink_rows(label, batch, *runs):
    """bool[B] on the CPU: the rows of `batch` whose pair-scorer ReLU input
    (fc1 of pea_predict, for the positive and the negative item) lies,
    in either of two runs, within twice the runs' own difference of 0, a
    flip of sign included.  runs: two (model, forward), forward(model) ->
    the cached representation, on any device.  Fails if more than
    KINK_ROW_SHARE of the rows are such: the forwards then disagree."""
    from graph_recsys_benchmark_tpu_torch.nn.init import linear

    pres = []
    with torch.no_grad():
        for model, forward in runs:
            rep, b = forward(model), batch.to(model.x.device)
            pres.append(torch.stack([
                linear(model.fc1, torch.cat([rep[b[:, 0]], rep[b[:, c]]], dim=-1))
                for c in (1, 2)]).double().cpu())
    margin = 2.0 * (pres[0] - pres[1]).abs()
    rows = ((pres[0].abs() <= margin) | (pres[1].abs() <= margin)).any(-1).any(0)
    n = int(rows.sum())
    check(n <= KINK_ROW_SHARE * batch.shape[0],
          f"{label}: {n} of {batch.shape[0]} batch rows at the scorer's ReLU kink")
    return rows


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
    """The HIN and, per conv (gat, gcn, sage) and transport, a PEATrainer on
    the card with bench.py:42-59's configuration."""
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
    trainers = {}
    for conv in ("gat", "gcn", "sage"):
        cfg = PEAConfig(
            conv=conv, num_nodes=hin.num_nodes, meta_path_steps=(2,) * 9,
            emb_dim=64, hidden_size=64, repr_dim=16, entity_aware=True,
        )
        trainers[conv] = {
            t: PEATrainer(hin, cfg, TrainConfig(), device="cuda", transport=t)
            for t in ("f32", "bf16")
        }
    return hin, trainers


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


def print_runs(label, g, num_rows):
    """id_runs of a GAT graph's sources and dsts, real edges only, in the
    edges' own (128-row dst block) order and in the walks of the GAT
    backwards (StepGraph.src_perm / src_sorted) and forwards (dst_perm /
    dst_sorted); also checks each walk is ids[perm]."""
    for side, what in (("src", "a source"), ("dst", "a dst row")):
        ids, perm, srt = (getattr(g, f"{side}{x}") for x in ("", "_perm", "_sorted"))
        check(torch.equal(srt, ids[perm.long()]), f"{label}: {side}_sorted is not "
              f"{side}[{side}_perm]")
        pad = torch.full_like(ids, num_rows)
        block = id_runs(torch.where(g.dst < num_rows, ids, pad), num_rows)[0]
        walk = id_runs(torch.where(g.dst[perm.long()] < num_rows, srt, pad), num_rows)[0]
        print(f"{label}: mean edges {what} takes (run, 32-edge window, 2,048-edge chunk, "
              f"call): block order {[round(x, 2) for x in block]}, {side} walk "
              f"{[round(x, 2) for x in walk]}", flush=True)


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
        fwalk = dict(dst_perm=union.dst_perm, dst_sorted=union.dst_sorted)
        acc = fg.flash_gat_fwd(*args, **fwalk)
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
            ms=device_ms(lambda: fg.flash_gat_fwd(*args, **fwalk)),
            plain_ms=device_ms(lambda: fg.flash_gat_fwd_plain(*args), reps=10),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        )
        print(f"flash_gat_fwd {transport}: rows {n_v} kz {kz1} edges {e_union} "
              f"(padded {union.dst.numel()}) rel_err {rel:.3e} bytes = [z | a_src] "
              f"{n_v * (kz1 + 1)}x{itemsize} + a_dst,m^ {2 * n_v}x4 + src,dst "
              f"{e_union}x8 + acc {n_v * (kz1 + 1)}x4 = {nbytes}", flush=True)

        gtab, logden = bwd_stats(acc, mhat, 1, kz1, t_dtype, randn(n_v, 1, kz1))
        bargs = (table, gtab, logden[0], adst_r, union.src, union.dst, n_v, kz1)
        walk = dict(src_perm=union.src_perm, src_sorted=union.src_sorted)
        err, rel = check_kernel("flash_gat_bwd", transport, fg.flash_gat_bwd(*bargs, **walk),
                                fg.flash_gat_bwd_plain(*bargs))
        # reads each node's [z | a_src] and stat row [g | gout], logden and
        # a_dst, the real edges' ids; writes dpk [dz | da_src] and da_dst
        nbytes = (n_v * (kz1 + 1) * (itemsize + 4) + 2 * n_v * 4 + e_union * 8
                  + n_v * (kz1 + 1) * 4 + n_v * 4)
        flops = e_union * (4 * kz1 + 14)
        b_ms, b_by = bound_ms(nbytes, flops)
        results[("flash_bwd", transport)] = dict(
            max_abs_err=err,
            ms=device_ms(lambda: fg.flash_gat_bwd(*bargs, **walk)),
            plain_ms=device_ms(lambda: fg.flash_gat_bwd_plain(*bargs), reps=10),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        )
        print(f"flash_gat_bwd {transport}: rows {n_v} kz {kz1} edges {e_union} "
              f"rel_err {rel:.3e} bytes = [z | a_src] {n_v * (kz1 + 1)}x{itemsize} + "
              f"[g | gout] {n_v * (kz1 + 1)}x4 + logden,a_dst {2 * n_v}x4 + src,dst "
              f"{e_union}x8 + dpk {n_v * (kz1 + 1)}x4 + da_dst {n_v}x4 = {nbytes}",
              flush=True)
        if transport == "f32":
            print_runs("union", union, n_v)

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
            fwalk = dict(dst_perm=g.dst_perm, dst_sorted=g.dst_sorted)
            acc = bg.batch_gat_fwd(*fargs, **fwalk)
            gtab, logden = bwd_stats(acc, mh, n_ch, kz2, t_dtype,
                                     randn(num_nodes, n_ch, kz2))
            bargs = (tab, gtab, logden, ad, g.src, g.dst, num_nodes, kz2)
            walk = dict(src_perm=g.src_perm, src_sorted=g.src_sorted)
            if transport == "f32":
                print_runs(f"share {chans}", g, num_nodes)
            for key, fn, plain, a, kw, nbytes, flops in (
                ("batch_fwd", bg.batch_gat_fwd, bg.batch_gat_fwd_plain, fargs, fwalk,
                 tab.numel() * itemsize + 2 * ad.numel() * 4 + g.num_edges * 8
                 + tab.numel() * 4,
                 g.num_edges * n_ch * (2 * (kz2 + 1) + 6)),
                ("batch_bwd", bg.batch_gat_bwd, bg.batch_gat_bwd_plain, bargs, walk,
                 tab.numel() * (itemsize + 4) + 2 * ad.numel() * 4 + g.num_edges * 8
                 + tab.numel() * 4 + ad.numel() * 4,
                 g.num_edges * n_ch * (4 * kz2 + 14)),
            ):
                got = fn(*a, **kw)
                err, rel = check_kernel(fn.__name__, transport,
                                        got if isinstance(got, tuple) else [got],
                                        plain(*a) if key == "batch_bwd" else [plain(*a)])
                ms = device_ms(lambda: fn(*a, **kw))
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
    from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk
    from graph_recsys_benchmark_tpu_torch.ops import stream_gat as sg

    return {"flash_fwd": fg.flash_gat_fwd, "batch_fwd": bg.batch_gat_fwd,
            "flash_bwd": fg.flash_gat_bwd, "batch_bwd": bg.batch_gat_bwd,
            "rowmax": fg.gat_rowmax, "flash_fwd_online": fg.flash_gat_fwd_online,
            "flash_bwd_glue": fg.flash_gat_bwd_glue,
            "flash_bwd_onepass": fg.flash_gat_bwd_onepass,
            "segsum": sk.sorted_segment_sum, "gather": sk.sorted_broadcast,
            "scatter": sk.localized_scatter_add, "softmax": sk.softmax_stats,
            "stream_fwd": sg.stream_gat_fwd, "stream_bwd_dst": sg.stream_gat_bwd_dst,
            "stream_bwd_src": sg.stream_gat_bwd_src}


def reset_launches():
    for fn in _counters().values():
        fn.launches = 0


def read_launches():
    return {k: fn.launches for k, fn in _counters().items()}


def expected(**counts):
    """Every wrapper's launch count: the ones named, 0 for the rest."""
    return {k: counts.get(k, 0) for k in _counters()}


def slice_phase(cfg, trainers):
    from graph_recsys_benchmark_tpu_torch.models.pea import pea_forward

    out = {}
    for transport, trainer in trainers.items():
        params = trainer.init(2020)
        reset_launches()
        res = trainer.evaluate(params, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        launches = read_launches()
        check(launches == expected(flash_fwd=1, batch_fwd=2),
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


def matmul_shapes(fn, label):
    """The matrix products of fn() (aten mm / bmm / addmm / baddbmm ops) by
    device time, with their input shapes (torch.profiler record_shapes):
    names the products behind the cuBLAS kernels of device_breakdown."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(getattr(e, "device_time_total", 0.0), e.count, e.key, e.input_shapes)
            for e in prof.key_averages(group_by_input_shape=True)
            if e.key in ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")]
    for us, count, key, shapes in sorted(rows, reverse=True)[:4]:
        print(f"  {label} {key} x{count}: {us:.1f} us of device time, inputs {shapes}",
              flush=True)


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
        check(step_launches == expected(flash_fwd=1, batch_fwd=2, flash_bwd=1, batch_bwd=2),
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
        kinks = kink_rows(transport, batch, (params, trainer.eval_forward),
                          (cpu_params, cpu.eval_forward))
        rmask = ((torch.arange(bs) < bs - 100) & ~kinks).float()  # a partial batch
        loss = trainer.batch_loss(params, batch.cuda(), rmask.cuda())
        loss.backward()
        cpu_loss = cpu.batch_loss(cpu_params, batch, rmask)
        cpu_loss.backward()
        torch.cuda.synchronize()
        tol = FORWARD_TOL[transport]
        _, rel = rel_err(loss.detach().cpu(), cpu_loss.detach())
        check(rel <= tol, f"{transport} step loss vs CPU: relative error {rel} > {tol}")
        errs = leaf_errors(transport, params, cpu_params)
        median, worst = errs[len(errs) // 2], errs[-1]
        check(median[0] <= tol and worst[0] <= KINK_TOL,
              f"{transport} grads vs CPU: median {median} > {tol} or worst {worst} > {KINK_TOL}")
        print(f"train {transport}: one step launches {step_launches}; loss "
              f"{float(loss.detach()):.6f} vs CPU {float(cpu_loss.detach()):.6f} (rel "
              f"{rel:.3e}); gradients vs CPU: median {median[1]} rel {median[0]:.3e}, worst "
              f"{worst[1]} rel {worst[0]:.3e}, {sum(e > tol for e, _ in errs)} of {len(errs)} "
              f"over {tol}; {int(kinks.sum())} kink row(s) left out", flush=True)

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
        check(launches == expected(flash_fwd=n, batch_fwd=2 * n, flash_bwd=n, batch_bwd=2 * n),
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


# message width per step of the union graphs: PEAGCN sums its projected z
# (hidden 64, then repr 16), PEASage its un-projected input (emb 64, hidden
# 64); cli_phase takes PEAGCN's step 1 at --hidden_size 300 (edge_cases)
SEG_WIDTHS = {"gcn": (64, 16), "sage": (64, 64)}
SEG_KERNELS = {"segsum": "sorted_segment_sum", "gather": "sorted_broadcast",
               "scatter": "localized_scatter_add"}


def edge_kernel_phase(trainers):
    """K5, K7 and K6 against their plain versions at every shape the
    flagship's PEAGCN and PEASage union graphs give them (edge_cases), per
    transport."""
    rng = np.random.default_rng(1)
    results = {}
    for conv, widths in SEG_WIDTHS.items():
        graphs = trainers[conv]["f32"].graphs
        for step, (g, d) in enumerate(zip(graphs, widths), start=1):
            edge_cases(g, d, f"{conv} step {step}", conv, rng, results)
    return results


def edge_cases(g, d, label, conv, rng, results):
    """K5, K7 and K6 on a union graph g at message width d (the edge lists
    a path hands them, random rows from rng), per transport: the largest
    error against the plain version (K7 a copy, equal bitwise; K5 and K6
    sum in f32 in another order than it, so each row is held to the same
    sums taken in float64, within the rounding bound of an f32 sum in any
    order (sum_bound): two f32 orders can differ by more than either
    differs from the exact sum, and a fixed share of the largest value
    (1e-6, once) is no bound: 1.0026e-6 was seen at PEAGCN step 1), device
    ms of the wrapper, of the plain version and of one PyTorch call of the
    same function (index_add_ for K5 and K6 into a zeroed table with a
    sentinel row, in the inputs' dtype; index_select for K7 from a table
    with a zero row), and the bound, summed into results[(kind, conv,
    transport)].
    Bytes counted: K5 reads every dst id and the real edges' messages and
    writes the f32 table; K7 reads the ids and the table and writes every
    edge's row; K6 reads every edge's id and row (the padding edges' rows
    are zeros the kernel cannot skip) and writes the f32 table."""
    from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk
    from graph_recsys_benchmark_tpu_torch.ops.segment import segment_sum

    dev = torch.device("cuda")
    n, e_pad, e = g.num_nodes, g.dst.numel(), g.num_edges
    src64 = g.src.long()
    dst64 = torch.clamp(g.dst.long(), max=n)
    for transport, t_dtype in TDT.items():
        it = torch.finfo(t_dtype).bits // 8

        def randn(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32)).to(dev).to(t_dtype)

        msgs, table, ct = randn(e_pad, d), randn(n, d), randn(e_pad, d)
        ct[e:] = 0  # padding edges carry zero cotangent (graph.py)
        tpad = torch.cat([table, table.new_zeros(1, d)])
        exact = {"segsum": segment_sum(msgs.double(), g.dst, n),
                 "scatter": segment_sum(ct.double(), g.src, n)}
        sbound = {"segsum": sum_bound(msgs.double(), g.dst, n),
                  "scatter": sum_bound(ct.double(), g.src, n)}
        # the kernels walk the edges as the path does (by dst for K5,
        # by src for K6: the graph's sorted orders)
        dst_walk, src_walk = (g.dst_perm, g.dst_sorted), (g.src_perm, g.src_sorted)
        cases = {
            "segsum": (lambda: sk.sorted_segment_sum(msgs, g.dst, n, transport, dst_walk),
                       lambda: sk.sorted_segment_sum_plain(msgs, g.dst, n, transport),
                       lambda: torch.zeros(n + 1, d, dtype=t_dtype, device=dev)
                       .index_add_(0, dst64, msgs),
                       e_pad * 4 + e * d * it + n * d * 4, e * d),
            "gather": (lambda: sk.sorted_broadcast(table, g.src, n),
                       lambda: sk.sorted_broadcast_plain(table, g.src, n),
                       lambda: torch.index_select(tpad, 0, src64),
                       e_pad * 4 + n * d * it + e_pad * d * it, 0),
            "scatter": (lambda: sk.localized_scatter_add(ct, g.src, n, transport, src_walk),
                        lambda: sk.localized_scatter_add_plain(ct, g.src, n, transport),
                        lambda: torch.zeros(n + 1, d, dtype=t_dtype, device=dev)
                        .index_add_(0, src64, ct),
                        e_pad * 4 + e_pad * d * it + n * d * 4, e_pad * d),
        }
        for kind, (fn, plain, lib, nbytes, flops) in cases.items():
            got, want = fn(), plain()
            torch.cuda.synchronize()
            check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                  f"{kind} {label} {transport}: shape or non-finite")
            err, rel = rel_err(got, want)
            if kind == "gather":
                check(torch.equal(got, want), f"gather {label} {transport}: "
                      f"not a bitwise copy (max abs {err})")
                exact_rel, share = rel, 0.0
            else:
                exact_rel = rel_err(got.double(), exact[kind])[1]
                share = check_sum(f"{kind} {label} {transport}", got, exact[kind],
                                  sbound[kind])
            ms = device_ms(fn)
            plain_ms = device_ms(plain, reps=10)
            lib_ms = device_ms(lib)
            b_ms, b_by = bound_ms(nbytes, flops)
            print(f"{SEG_KERNELS[kind]} {transport}: {label} rows {n} D {d} "
                  f"edges {e} (padded {e_pad}) rel_err {rel:.3e} (vs float64 "
                  f"{exact_rel:.3e}, {share:.3f} of the rounding bound) ms {ms:.5f} plain_ms "
                  f"{plain_ms:.5f} library_ms {lib_ms:.5f} bound_ms {b_ms:.5f} "
                  f"({b_by}; {nbytes} bytes)", flush=True)
            agg = results.setdefault((kind, conv, transport), dict(
                max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                bound_by="bytes", shapes=[]))
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                             ("library_ms", lib_ms)):
                agg[key] += val
            agg["shapes"].append(f"D {d} x {e} edges")


def fused_phase(hin, trainers, epochs):
    """PEAGCN or PEASage through PEATrainer, per transport, at full width
    and depth: the eval's launch counts (K7 2, K5 2) and metrics, and its
    cached representation against a CPU copy; one step's launch counts (K7
    4, K5 2, K6 2) and its loss and every gradient against a CPU copy
    (median leaf at FORWARD_TOL, every leaf at KINK_TOL; weights off the
    init regime; a seeded batch without its kink_rows); `epochs` epochs with the counts read over the last, its
    loss finite (falling, for two), HR@10 after; eval wall and a profiled
    eval and step."""
    from graph_recsys_benchmark_tpu_torch.models.pea import pea_forward, pea_loss

    out = {}
    for transport, trainer in trainers.items():
        cfg, bs, n = trainer.cfg, trainer.tcfg.batch_size, trainer.num_batches
        label = f"{cfg.conv} {transport}"
        cpu_graphs = tuple(g.to("cpu") for g in trainer.graphs)
        # ---- the eval: launches, metrics, the forward against the CPU's
        params = trainer.init(2020)
        reset_launches()
        res = trainer.evaluate(params, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        eval_launches = read_launches()
        check(eval_launches == expected(gather=2, segsum=2),
              f"{label} eval: launches {eval_launches}, expected gather 2, segsum 2")
        for k in ("HR", "NDCG", "AUC", "eval_loss"):
            check(bool(torch.isfinite(res[k]).all()), f"{label} eval: {k} not finite")
        with torch.no_grad():
            rep = trainer.eval_forward(params)
            cpu_rep = pea_forward(copy.deepcopy(params).cpu(), cpu_graphs, cfg,
                                  transport=transport)
        check(rep.shape == (cfg.num_nodes, cfg.repr_dim) and bool(torch.isfinite(rep).all()),
              f"{label}: repr shape {tuple(rep.shape)} or not finite")
        _, fwd_rel = rel_err(rep.cpu(), cpu_rep)
        check(fwd_rel <= FORWARD_TOL[transport],
              f"{label} forward vs CPU copy: relative error {fwd_rel}")
        print(f"{label} eval (untrained): launches {eval_launches} HR@10 "
              f"{float(res['HR'][5]):.4f} NDCG@10 {float(res['NDCG'][5]):.4f} AUC "
              f"{float(res['AUC']):.4f}; repr vs CPU rel {fwd_rel:.3e}", flush=True)

        # ---- one step's launch counts, through the main path's step
        opt = trainer.optimizer(params)
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows = torch.arange(bs, device="cuda")
        mask = torch.ones(bs, device="cuda")
        reset_launches()
        trainer.train_step(params, opt, rows, mask, gen)
        torch.cuda.synchronize()
        step_launches = read_launches()
        check(step_launches == expected(gather=4, segsum=2, scatter=2),
              f"{label} train step: launches {step_launches}")

        # ---- one step's loss and gradients, card vs a CPU copy
        params = trainer.init(2020)
        with torch.no_grad():
            params.x.mul_(10.0)
            params.fc1["b"].mul_(0.1)
        cpu_params = copy.deepcopy(params).cpu()
        picked = torch.randperm(trainer.n_rows, device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(3))[:bs]
        batch = trainer._build_batch(picked, gen)
        kinks = kink_rows(label, batch, (params, trainer.eval_forward), (
            cpu_params, lambda m: pea_forward(m, cpu_graphs, cfg, transport=transport)))
        rmask = ((torch.arange(bs) < bs - 100) & ~kinks).float()  # a partial batch
        loss = trainer.batch_loss(params, batch, rmask.cuda())
        loss.backward()
        cpu_loss = pea_loss(cpu_params, cpu_graphs, cfg, batch.cpu(), row_mask=rmask,
                            transport=transport)
        cpu_loss.backward()
        torch.cuda.synchronize()
        tol = FORWARD_TOL[transport]
        _, rel = rel_err(loss.detach().cpu(), cpu_loss.detach())
        check(rel <= tol, f"{label} step loss vs CPU: relative error {rel} > {tol}")
        errs = leaf_errors(label, params, cpu_params)
        median, worst = errs[len(errs) // 2], errs[-1]
        check(median[0] <= tol and worst[0] <= KINK_TOL,
              f"{label} grads vs CPU: median {median} > {tol} or worst {worst} > {KINK_TOL}")
        print(f"train {label}: one step launches {step_launches}; loss "
              f"{float(loss.detach()):.6f} vs CPU {float(cpu_loss.detach()):.6f} (rel "
              f"{rel:.3e}); gradients vs CPU: median {median[1]} rel {median[0]:.3e}, worst "
              f"{worst[1]} rel {worst[0]:.3e}, {sum(e > tol for e, _ in errs)} of {len(errs)} "
              f"over {tol}; {int(kinks.sum())} kink row(s) left out", flush=True)

        # ---- epochs, the counts read over the last
        params = trainer.init(2020)
        opt = trainer.optimizer(params)
        gen = torch.Generator(device="cuda").manual_seed(7)
        secs, losses = [], []
        for _ in range(epochs):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(trainer.run_epoch(params, opt, gen)))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = read_launches()
        check(launches == expected(gather=4 * n, segsum=2 * n, scatter=2 * n),
              f"{label} epoch: launches {launches}, expected {4 * n}/{2 * n}/{2 * n}")
        check(all(np.isfinite(losses)), f"{label}: epoch losses {losses}")
        check(epochs < 2 or losses[-1] < losses[0],
              f"{label}: last epoch mean loss {losses[-1]} not below the first {losses[0]}")
        res = trainer.evaluate(params, torch.Generator(device="cuda").manual_seed(0))
        hr10 = float(res["HR"][5])
        check(epochs < 2 or hr10 > 0.10, f"{label}: HR@10 {hr10} after {epochs} epochs")
        step_ms = secs[-1] / n * 1e3
        print(f"train {label}: {trainer.n_rows} rows, {n} steps of {bs}; epoch mean loss "
              f"{' -> '.join(f'{x:.6f}' for x in losses)}; epoch s "
              f"{' '.join(f'{x:.3f}' for x in secs)}; train examples/s "
              f"{trainer.n_rows / secs[-1]:.1f} (last epoch); step ms {step_ms:.4f}; launches "
              f"over the last epoch {launches}; after {epochs} epoch(s) HR@10 {hr10:.4f} "
              f"NDCG@10 {float(res['NDCG'][5]):.4f} AUC {float(res['AUC']):.4f}", flush=True)
        device_breakdown(lambda: trainer.train_step(params, opt, rows, mask, gen),
                         f"train step {label}", step_ms)
        walls = []
        for i in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.evaluate(params, torch.Generator(device="cuda").manual_seed(i + 1))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        print(f"eval wall ms {label}: median {wall:.4f} runs {[round(w, 4) for w in walls]}",
              flush=True)
        device_breakdown(lambda: trainer.evaluate(
            params, torch.Generator(device="cuda").manual_seed(99)), f"eval {label}", wall)
        out[transport] = dict(launches=launches, eval_launches=eval_launches)
    return out


# ---------------------------------------------------------------- flash-GAT
# variant routes (ops/config.FlashGATMode)

# the modes other than the default, and each one's extra launches per eval
# (forward) and per step (forward and backward) in place of K1/K12 and K2
MODES = {"online-fused": dict(fwd=dict(rowmax=1, flash_fwd_online=1),
                              bwd=dict(flash_bwd=1)),
         "bound-glue": dict(fwd=dict(flash_fwd=1), bwd=dict(flash_bwd_glue=1, scatter=1)),
         "bound-onepass": dict(fwd=dict(flash_fwd=1), bwd=dict(flash_bwd_onepass=1))}
MODE_STEPS = 20


def ulp(x, t_dtype):
    """One unit in the last place of |x| in `t_dtype` (f32 24 bits, bf16 8)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x.float()), e - (24 if t_dtype == torch.float32 else 8))


def k2_terms(table, gtab, logden, adst_r, s, d, kz, t_dtype):
    """The float64 terms that K2's rounding points add for the real edges
    (s, d), as the plain version computes them: da_dst's dpre [E, 1] and the
    cotangent rows [round_T(g * att) | round_T(dpre)] [E, kz+1], each with a
    bound on its own error.  The kernel sums datt's kz products in another
    order than torch (each order within gamma_(kz-1) * sum |g z| of the
    exact sum, so the two at most twice that apart), which att and leaky'
    scale; the three roundings after it add 6 units of |dpre|, and bf16's
    rounding of a moved dpre one unit of bf16 (2^-7 of it).  att is the same
    f32 computation in both, so the dz columns are exact."""
    from graph_recsys_benchmark_tpu_torch.ops import flash_gat as fg

    rows = table[s].float()
    g = gtab[d]
    pre = adst_r[0, d] + rows[:, kz]
    att = torch.exp(torch.clamp(torch.where(pre > 0, pre, 0.2 * pre) - logden[0, d], max=60.0))
    ct, dpre = fg._bwd_edge_terms(table, gtab, logden, adst_r, s, d, kz, False, 0.2)
    prod = (g[:, :kz] * rows[:, :kz]).abs().sum(1).double()
    gam = (kz - 1) * U_SUM / (1 - (kz - 1) * U_SUM)
    sigma = torch.where(pre > 0, 1.0, 0.2).double()
    err = (2 * gam * prod * att.double() * sigma * (1 + 4 * U_SUM)
           + 6 * U_SUM * dpre[:, 0].abs().double())
    ct_err = torch.zeros(ct.shape, dtype=torch.float64, device=ct.device)
    ct_err[:, kz] = err + (2.0 ** -7 * (dpre[:, 0].abs().double() + err)
                           if t_dtype == torch.bfloat16 else 0.0)
    return dpre.double(), err[:, None], ct.double(), ct_err


def mode_kernel_phase(plan, num_nodes):
    """K12-online (gat_rowmax, flash_gat_fwd_online), K13
    (flash_gat_bwd_glue, then K6 localized_scatter_add on its rows) and K14
    (flash_gat_bwd_onepass) at the step-1 union graph's shapes (kz 64), per
    transport, on random tables from a numpy seed and the stats of the
    forward on them, K12-online and K13 on the graph's walk by dst and K14
    on its walk by source: each against its plain version on the card
    (gat_rowmax's m bitwise; the walk within KERNEL_TOL, as K1, whose
    arithmetic the walk shares; K13's stored rows each within one unit of
    the transport's last place of the plain version's, since datt may sum
    in another order, and its padding rows exact zeros; K6 on them within
    sum_bound of the float64 sums of the same rows; K13's da_dst and K14's
    dpk and da_dst row by row within sum_bound of the float64 sums of the
    plain version's terms, k2_terms), device ms, plain ms, the bound, and
    the library call where one computes the function (scatter_reduce_ amax
    of the edge logits for the row max; index_add_ for K6)."""
    from graph_recsys_benchmark_tpu_torch.ops import flash_gat as fg
    from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk
    from graph_recsys_benchmark_tpu_torch.ops.segment import segment_sum

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    (_, union, rest), _ = plan.steps
    n_v, kz = len(rest) * num_nodes, 64
    e, src, dst = union.num_edges, union.src, union.dst
    fwalk = dict(dst_perm=union.dst_perm, dst_sorted=union.dst_sorted)
    walk = dict(src_perm=union.src_perm, src_sorted=union.src_sorted)
    real = dst < n_v
    rows_hit = int(torch.unique(dst[real]).numel())
    results = {}
    for transport, t_dtype in TDT.items():
        it = torch.finfo(t_dtype).bits // 8
        table = randn(n_v, kz + 1).to(t_dtype)
        adst_r = randn(n_v).to(t_dtype).float()

        def record(key, fn, plain, nbytes, flops, err, lib=None, what=""):
            b_ms, b_by = bound_ms(nbytes, flops)
            r = dict(max_abs_err=err, ms=device_ms(fn), plain_ms=device_ms(plain, reps=10),
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=None if lib is None else device_ms(lib))
            results[(key, transport)] = r
            print(f"{key} {transport}: rows {n_v} kz {kz} edges {e} max_abs_err {err:.3e} "
                  f"ms {r['ms']:.5f} plain_ms {r['plain_ms']:.5f} library_ms "
                  f"{r['library_ms']} bound_ms {b_ms:.5f} ({b_by}; {nbytes} bytes){what}",
                  flush=True)

        # ---- K12-online: the row max, then the walk with m as the shift
        rargs = (table, adst_r, src, dst, n_v, kz)
        m = fg.gat_rowmax(*rargs, **fwalk)
        m_plain = fg.gat_rowmax_plain(*rargs)
        torch.cuda.synchronize()
        check(torch.equal(m, m_plain), f"gat_rowmax {transport}: m not bitwise the plain "
              f"version's (max abs {rel_err(m, m_plain)[0]})")
        pre = adst_r[dst[real].long()] + table[src[real].long(), kz].float()
        act = torch.where(pre > 0, pre, 0.2 * pre)
        d_real = dst[real].long()
        record("rowmax", lambda: fg.gat_rowmax(*rargs, **fwalk),
               lambda: fg.gat_rowmax_plain(*rargs),
               # a_src column, a_dst, the real edges' ids, m
               n_v * it + n_v * 4 + e * 8 + n_v * 4, e * 4, 0.0,
               lib=lambda: torch.full((n_v,), float("-inf"), device=dev)
               .scatter_reduce_(0, d_real, act, "amax"),
               what=f" (library: scatter_reduce_ amax of precomputed edge logits; {rows_hit} "
                    f"rows with an edge, one atomic a run of the walk and a 64-position "
                    f"slice)")
        wargs = (table, adst_r, m, src, dst, n_v, kz)
        acc = fg.flash_gat_fwd_online(*wargs, **fwalk)
        err, _ = check_kernel("flash_gat_fwd_online", transport, [acc],
                              [fg.flash_gat_fwd_plain(*wargs)])
        record("flash_fwd_online", lambda: fg.flash_gat_fwd_online(*wargs, **fwalk),
               lambda: fg.flash_gat_fwd_plain(*wargs),
               n_v * (kz + 1) * it + 2 * n_v * 4 + e * 8 + n_v * (kz + 1) * 4,
               e * (2 * (kz + 1) + 6), err)

        # ---- K13, then K6 on its rows
        g = randn(n_v, kz)
        gtab, logden = bwd_stats(acc, m, 1, kz, t_dtype, g[:, None])
        gargs = (table, gtab, logden[0], adst_r, src, dst, n_v, kz)
        # leave NaNs where ct's torch.empty will land: every row must be written
        torch.full((dst.numel(), kz + 1), float("nan"), dtype=t_dtype, device=dev)
        ct, da = fg.flash_gat_bwd_glue(*gargs, **fwalk)
        ct_p, da_p = fg.flash_gat_bwd_glue_plain(*gargs)
        torch.cuda.synchronize()
        check(ct.dtype == t_dtype and not ct[~real].any(),
              f"flash_gat_bwd_glue {transport}: dtype {ct.dtype} or nonzero padding rows")
        diff = (ct.float() - ct_p.float()).abs()
        check(bool((diff <= torch.maximum(ulp(ct, t_dtype), ulp(ct_p, t_dtype))).all()),
              f"flash_gat_bwd_glue {transport}: a stored row off the plain version's by more "
              f"than one unit in the last place")
        n_apart = int((diff > 0).sum())
        s_r, d_r = src[real].long(), dst[real].long()
        dpre, dpre_err, _, _ = k2_terms(table, gtab, logden, adst_r[None], s_r, d_r, kz,
                                        t_dtype)
        ex_da = segment_sum(dpre, d_r, n_v)
        da_share = check_sum(f"flash_gat_bwd_glue da_dst {transport}", da[:, None], ex_da,
                             sum_bound(dpre, d_r, n_v, dpre_err))
        err = max(float((da.double() - ex_da[:, 0]).abs().max()), float(diff.max()))
        record("flash_bwd_glue", lambda: fg.flash_gat_bwd_glue(*gargs, **fwalk),
               lambda: fg.flash_gat_bwd_glue_plain(*gargs),
               # [z | a_src], [g | gout], logden, a_dst, ids; ct, da_dst
               n_v * (kz + 1) * (it + 4) + 2 * n_v * 4 + e * 8 + e * (kz + 1) * it + n_v * 4,
               e * (4 * kz + 14), err,
               what=f" (ct elements not bitwise the plain version's: {n_apart}; da_dst "
                    f"against the float64 sums, {da_share:.3f} of the rounding bound)")
        dpk = sk.localized_scatter_add(ct, src, n_v, transport)
        exact = segment_sum(ct.double(), src, n_v)
        share = check_sum(f"localized_scatter_add of K13's rows {transport}", dpk, exact,
                          sum_bound(ct.double(), src, n_v))
        src64 = src.long()
        record("scatter_glue", lambda: sk.localized_scatter_add(ct, src, n_v, transport),
               lambda: sk.localized_scatter_add_plain(ct, src, n_v, transport),
               # every edge's id and row (padding rows are zeros it cannot skip), dpk
               ct.shape[0] * 4 + ct.numel() * it + n_v * (kz + 1) * 4, ct.numel(),
               rel_err(dpk.double(), exact)[0],
               lib=lambda: torch.zeros(n_v, kz + 1, dtype=t_dtype, device=dev)
               .index_add_(0, src64, ct),
               what=f" ({share:.3f} of the rounding bound)")

        # ---- K14: g unrounded in its stat table, on the walk by source
        stat = torch.cat([g, gtab[:, kz:], logden[0][:, None], adst_r[:, None]], dim=1)
        oargs = (table, stat, src, dst, n_v, kz)
        dpk, da = fg.flash_gat_bwd_onepass(*oargs, **walk)
        torch.cuda.synchronize()
        check(dpk.shape == (n_v, kz + 1) and da.shape == (n_v,)
              and bool(torch.isfinite(dpk).all()) and bool(torch.isfinite(da).all()),
              f"flash_gat_bwd_onepass {transport}: shapes {tuple(dpk.shape)}, "
              f"{tuple(da.shape)} or non-finite output")
        s_r, d_r = src[real].long(), dst[real].long()
        dpre, dpre_err, ct, ct_err = k2_terms(table, stat[:, : kz + 1], stat[None, :, kz + 1],
                                              stat[None, :, kz + 2], s_r, d_r, kz, t_dtype)
        ex_dpk, ex_da = segment_sum(ct, s_r, n_v), segment_sum(dpre, d_r, n_v)
        shares = (check_sum(f"flash_gat_bwd_onepass dpk {transport}", dpk, ex_dpk,
                            sum_bound(ct, s_r, n_v, ct_err)),
                  check_sum(f"flash_gat_bwd_onepass da_dst {transport}", da[:, None], ex_da,
                            sum_bound(dpre, d_r, n_v, dpre_err)))
        err = max(float((dpk.double() - ex_dpk).abs().max()),
                  float((da.double() - ex_da[:, 0]).abs().max()))
        record("flash_bwd_onepass", lambda: fg.flash_gat_bwd_onepass(*oargs, **walk),
               lambda: fg.flash_gat_bwd_onepass_plain(*oargs),
               # [z | a_src], the stat rows, ids; dpk, da_dst
               n_v * (kz + 1) * it + n_v * (kz + 3) * 4 + e * 8 + n_v * (kz + 1) * 4
               + n_v * 4, e * (4 * kz + 14), err,
               what=f" (against the float64 sums; shares of the rounding bound dpk "
                    f"{shares[0]:.3f}, da_dst {shares[1]:.3f})")
    return results


def _one_batch(trainer, probe, batch, rmask):
    """One batch's loss and gradients on a copy of `probe`: (loss, model)."""
    params = copy.deepcopy(probe)
    loss = trainer.batch_loss(params, batch, rmask)
    loss.backward()
    return loss.detach(), params


def _batch_errors(label, got, ref):
    """(loss rel, median leaf, worst leaf) of one _one_batch against another."""
    errs = leaf_errors(label, got[1], ref[1])
    return rel_err(got[0], ref[0])[1], errs[len(errs) // 2], errs[-1]


def mode_slice_phase(hin, cfg, trainers):
    """The PEAGAT trainer in each non-default mode (MODES), per transport,
    built from the user's entry point PEATrainer(..., flash_mode=...),
    against the default mode's trainer on the same weights and batches.
    One batch's loss and every gradient on weights off the init regime,
    (a) against the same mode with every kernel's plain version on the
    card (plain_on_card: the loss and the median leaf at FORWARD_TOL, every
    leaf at KINK_TOL), and (b) against the default mode, held alike but
    for the online forward's gradients in bf16, which are printed: the two
    shifts round p·z to bf16 apart, and the attention backward's
    near-cancellation datt - gout amplifies that (on the CPU's plain
    versions of this slice at small widths: median leaf 4e-3 at init, 6e-2
    off it).  Then MODE_STEPS steps from init(2020) on the same batches as the default
    mode, every step's loss at FORWARD_TOL and the counts read over them;
    then one eval, its launches, and its forward against the default
    mode's forward of the same trained weights (FORWARD_TOL).  The two
    runs' weights drift apart as the f32 atomics add in another order
    (a ReLU input at 0 flips, Adam's normalized step amplifies a near-zero
    gradient's noise), so their forwards after the steps are printed, not
    held.  Step ms, train examples/s and the card's busy share of one
    profiled step."""
    from graph_recsys_benchmark_tpu_torch.ops.config import FlashGATMode
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer

    out = {}
    for transport, default in trainers.items():
        bs = default.tcfg.batch_size
        tol = FORWARD_TOL[transport]
        mask = torch.ones(bs, device="cuda")
        windows = torch.randperm(default.n_rows, generator=torch.Generator().manual_seed(5))
        windows = [windows[i * bs:(i + 1) * bs].cuda() for i in range(MODE_STEPS)]
        probe = default.init(2020)
        with torch.no_grad():  # off the init regime (train_phase)
            probe.x.mul_(10.0)
            probe.fc1["b"].mul_(0.1)
        pgen = torch.Generator(device="cuda").manual_seed(11)
        batch = default._build_batch(windows[0], pgen)
        rmask = (torch.arange(bs, device="cuda") < bs - 100).float()

        def run(trainer):
            """MODE_STEPS steps from init(2020) on the fixed batches, the
            counts over them, the wall, and the forward after them."""
            params = trainer.init(2020)
            opt = trainer.optimizer(params)
            gen = torch.Generator(device="cuda").manual_seed(7)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            losses = [trainer.train_step(params, opt, w, mask, gen) for w in windows]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = read_launches()
            with torch.no_grad():
                rep = trainer.eval_forward(params)
            return params, opt, torch.stack(losses), secs, launches, rep

        _, _, d_losses, d_secs, _, d_rep = run(default)
        d_step = _one_batch(default, probe, batch, rmask)
        print(f"modes {transport}: default mode {MODE_STEPS} steps {d_secs:.3f} s "
              f"({MODE_STEPS * bs / d_secs:.1f} train examples/s)", flush=True)
        for name, counts in MODES.items():
            label = f"mode {name} {transport}"
            t0 = time.perf_counter()
            trainer = PEATrainer(hin, cfg, default.tcfg, device="cuda", transport=transport,
                                 flash_mode=FlashGATMode(*name.split("-")))
            build_s = time.perf_counter() - t0
            fwd = dict(counts["fwd"], batch_fwd=2)
            per_step = dict(fwd, batch_bwd=2, **counts["bwd"])
            # ---- one batch's loss and gradients: against the plain versions
            # on the card, and against the default mode
            step = _one_batch(trainer, probe, batch, rmask)
            with plain_on_card():
                plain = _one_batch(trainer, probe, batch, rmask)
            prel, pmed, pworst = _batch_errors(label, step, plain)
            check(prel <= tol and pmed[0] <= tol and pworst[0] <= KINK_TOL,
                  f"{label} vs its plain versions on the card: loss {prel}, median {pmed}, "
                  f"worst {pworst}")
            rel, median, worst = _batch_errors(label, step, d_step)
            check(rel <= tol, f"{label}: loss vs the default mode, relative error {rel} > {tol}")
            held = not (name.startswith("online") and transport == "bf16")
            check(not held or (median[0] <= tol and worst[0] <= KINK_TOL),
                  f"{label} grads vs the default mode: median {median} or worst {worst}")
            # ---- the steps, then one eval
            params, opt, losses, secs, launches, rep = run(trainer)
            check(launches == expected(**{k: MODE_STEPS * v for k, v in per_step.items()}),
                  f"{label}: launches over {MODE_STEPS} steps {launches}, expected {per_step} "
                  "each")
            _, lrel = rel_err(losses, d_losses)
            check(bool(torch.isfinite(losses).all()) and lrel <= tol,
                  f"{label}: step losses vs the default mode's, relative error {lrel}")
            drift = rel_err(rep, d_rep)[1]
            with torch.no_grad():
                _, frel = rel_err(rep, default.eval_forward(params))
            check(frel <= tol, f"{label}: forward vs the default mode's on the same weights, "
                  f"relative error {frel} > {tol}")
            reset_launches()
            res = trainer.evaluate(params, torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
            eval_launches = read_launches()
            check(eval_launches == expected(**fwd),
                  f"{label} eval: launches {eval_launches}, expected {fwd}")
            for k in ("HR", "NDCG", "AUC", "eval_loss"):
                check(bool(torch.isfinite(res[k]).all()), f"{label} eval: {k} not finite")
            step_ms = secs / MODE_STEPS * 1e3
            print(f"train {label}: trainer built in {build_s:.2f} s; one batch vs its plain "
                  f"versions on the card: loss rel {prel:.3e}, gradients median {pmed[1]} rel "
                  f"{pmed[0]:.3e}, worst {pworst[1]} rel {pworst[0]:.3e}; vs the default mode"
                  f"{'' if held else ' (gradients not held)'}: loss rel {rel:.3e}, gradients "
                  f"median {median[1]} rel {median[0]:.3e}, worst {worst[1]} rel "
                  f"{worst[0]:.3e}; {MODE_STEPS} steps: losses rel {lrel:.3e}, "
                  f"forward after them vs the default mode's on the same weights rel "
                  f"{frel:.3e} (vs the default mode's own run {drift:.3e}), step ms "
                  f"{step_ms:.4f}, train examples/s "
                  f"{MODE_STEPS * bs / secs:.1f}, launches {launches}; eval launches "
                  f"{eval_launches} HR@10 {float(res['HR'][5]):.4f}", flush=True)
            gen = torch.Generator(device="cuda").manual_seed(9)
            device_breakdown(lambda: trainer.train_step(params, opt, windows[0], mask, gen),
                             f"train step {label}", step_ms)
            out[(name, transport)] = dict(launches=launches, eval_launches=eval_launches)
            del trainer, params, opt
    return out


# ---------------------------------------------------------------- ML-25M


def build_ml25m():
    """tools/bench_25m.py:41-58's configuration built by the port's code:
    the HIN, then one PEATrainer per transport (each builds the graphs)."""
    from graph_recsys_benchmark_tpu_torch.data import ml25m_metapath_edges, synthetic_ml25m_hin
    from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

    t0 = time.perf_counter()
    hin = synthetic_ml25m_hin()
    t_hin = time.perf_counter() - t0
    cfg = PEAConfig(conv="gat", num_nodes=hin.num_nodes, meta_path_steps=(2,) * 13,
                    emb_dim=64, hidden_size=64, repr_dim=16, entity_aware=True)
    tcfg = TrainConfig(batch_size=4096, sampling_strategy="random")
    edges = ml25m_metapath_edges(hin)
    trainers, secs = {}, {}
    for t in TDT:
        t0 = time.perf_counter()
        trainers[t] = PEATrainer(hin, cfg, tcfg, edges, device="cuda", transport=t)
        torch.cuda.synchronize()
        secs[t] = time.perf_counter() - t0
    print(f"ml25m build: HIN {t_hin:.1f} s host; trainer (graphs + tables, to the card) "
          f"{' / '.join(f'{secs[t]:.1f}' for t in TDT)} s host (f32 / bf16)", flush=True)
    return hin, trainers


# the ML-25M relations by step graph, for the printout (ml25m_metapath_edges)
ML25M_STEPS = (("u2i", "i2u"), ("y2i", "i2u"), ("a2i", "i2u"), ("w2i", "i2u"),
               ("d2i", "i2u"), ("g2i", "i2u"), ("gt2i", "i2u"), ("u2t", "t2u"),
               ("i2t", "t2u"), ("i2u", "u2i"), ("t2u", "u2i"), ("i2t", "t2i"),
               ("u2t", "t2i"))


def ml25m_calls(graphs, kzs):
    """The grouped forward's calls, as models/pea._grouped_gat_forward
    makes them: per step, channels sharing a graph in chunks of <= 8; a
    chunk of >= 2 on a gat_loops graph is one streaming call, any other
    channel one gat_apply (streaming on a gat_loops graph, else composed).
    Returns (stream calls [(step, graph, chans, kz)], composed convs
    [(step, graph, chan)])."""
    stream, composed = [], []
    for k, kz in enumerate(kzs):
        groups = {}
        for c, ch in enumerate(graphs):
            groups.setdefault(id(ch[k]), []).append(c)
        for shared in groups.values():
            for i in range(0, len(shared), 8):
                chans = tuple(shared[i:i + 8])
                g = graphs[chans[0]][k]
                if g.gat_loops and len(chans) > 1:
                    stream.append((k, g, chans, kz))
                    continue
                for c in chans:
                    if g.gat_loops:
                        stream.append((k, g, (c,), kz))
                    else:
                        composed.append((k, g, c))
    return stream, composed


def ml25m_describe(hin, trainer):
    graphs = trainer.graphs
    stream, composed = ml25m_calls(graphs, (64, 16))
    seen = {}
    for c, ch in enumerate(graphs):
        for k, g in enumerate(ch):
            seen.setdefault(id(g), [g, ML25M_STEPS[c][k], []])[2].append((c, k + 1))

    def skew(g):
        """The streaming graphs' skew, which K10's and K11's pieces meet:
        the busiest 128-row block by dst and by src, the largest degrees."""
        if not g.gat_loops:
            return ""
        real = g.dst < g.num_nodes
        deg = [int(torch.bincount(ids[real].long(), minlength=g.num_nodes).max())
               for ids in (g.dst, g.src)]
        return (f"; busiest 128-row block {int(torch.diff(g.block_bounds).max())} edges by dst, "
                f"{int(torch.diff(g.src_block_bounds).max())} by src; largest in-degree "
                f"{deg[0]}, out-degree {deg[1]}")

    rows = [f"{name} rows {g.num_nodes} edges {g.num_edges} padded {g.dst.numel()} "
            f"{'implicit loops' if g.gat_loops else 'loop edges'} (channel, step) {uses}"
            f"{skew(g)}" for g, name, uses in seen.values()]
    print(f"ml25m: {hin.num_nodes} nodes, {hin.train_pos.shape[0]} train interactions, "
          f"{hin.candidates.seen.shape[0]} test users (seen lists {hin.candidates.seen.shape}); "
          f"{len(seen)} distinct step graphs:\n  " + "\n  ".join(rows), flush=True)
    for k in range(2):
        print(f"ml25m step {k + 1}: streaming calls "
              f"{[(len(ch), kz) for kk, _, ch, kz in stream if kk == k]} (channels "
              f"{[ch for kk, _, ch, _ in stream if kk == k]}); composed convs on channels "
              f"{[c for kk, _, c in composed if kk == k]}", flush=True)
    check(len(stream) == 4 and len(composed) == 15,
          f"ml25m: {len(stream)} streaming calls and {len(composed)} composed convs, "
          "expected 4 and 15")
    return stream, composed


# K9's, K10's and K11's piece-size sweep (edges a CTA) at the four streaming
# calls
STREAM_PIECES = (512, 1024, 2048, 4096, 8192)
# the kernels whose registers, shared memory and spills ptxas_summary prints
PTXAS_KERNELS = {"stream_gat": ("stream_gat_fwd_kernel", "stream_gat_bwd_dst_kernel",
                                "stream_gat_bwd_src_kernel"),
                 "segment": ("softmax_block_kernel",),
                 "gat_bwd": ("gat_bwd_walk_kernel", "gat_bwd_glue_walk_kernel"),
                 "gat_fwd": ("gat_fwd_walk_kernel", "gat_rowmax_walk_kernel")}


def ptxas_summary(logs):
    """ptxas's registers, shared memory and spills of each kernel of the
    streaming GAT (K9, K10, K11), of K8 and of the GAT walks (the forwards
    K1/K12 and K3 and K12-online's row max by dst, the backwards K2, K4 and
    K14 by source and K13 by dst; their template's int arguments: K3's or
    K4's rounding, lanes an edge, lanes a channel, columns a lane, the
    backward's wide passes and K14's stat rows; K13's columns a lane and
    wide passes; the row max's chunks a warp), one line each."""
    out = {}
    for source, kernels in PTXAS_KERNELS.items():
        cur = None
        for line in logs.get(source, "").splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1] if "'" in line else line
                cur = next((k for k in kernels if k in name), None)
                if cur:  # the transport type of a template kernel, its ints
                    targs = (["bf16"] if "bfloat16" in name else
                             ["f32"] if f"{cur}If" in name else [])
                    targs += re.findall(r"L[bi](\d+)E", name)
                    cur += f"<{', '.join(targs)}>" if targs else ""
                    out[cur] = []
            elif cur and ("Used" in line or "spill" in line):
                out[cur].append(line.split("info    :")[-1].strip())
    for name, lines in out.items():
        print(f"ptxas {name}: {'; '.join(lines)}", flush=True)


def ml25m_kernel_phase(trainer, stream, composed):
    """K8 on every composed graph (weighted by its uses in one forward) and
    K9-K11 at the four streaming calls, per transport, against their plain
    versions on the card (atomic sums against float64 sums)."""
    from graph_recsys_benchmark_tpu_torch.ops import flash_gat as fg
    from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk
    from graph_recsys_benchmark_tpu_torch.ops import stream_gat as sg

    dev = torch.device("cuda")
    rng = np.random.default_rng(25)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    uses = {}
    for _, g, _ in composed:
        uses.setdefault(id(g), [g, 0])[1] += 1
    results = {}
    for transport, t_dtype in TDT.items():
        it = torch.finfo(t_dtype).bits // 8
        # ---- K8: the logits are f32 in both transports
        agg = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   nbytes=0, flops=0)
        for g, m in uses.values():
            n, e_pad, e = g.num_nodes, g.dst.numel(), g.num_edges
            alpha = 3.0 * randn(e_pad)
            dst64 = torch.clamp(g.dst.long(), max=n)
            bb = g.block_bounds
            before = sk.softmax_stats.launches
            got = sk.softmax_stats(alpha, g.dst, n, bb)
            launches = sk.softmax_stats.launches - before
            plain = sk.softmax_stats_plain(alpha, g.dst, n)
            exact = sk.softmax_stats_plain(alpha.double(), g.dst, n)
            torch.cuda.synchronize()
            check(torch.equal(got[:, 0], plain[:, 0]), f"softmax_stats {transport}: max differs")
            err, rel = rel_err(got[:, 1].double(), exact[:, 1])
            # each term exp(a - max) carries the f32 subtraction's rounding
            # (at most U_SUM of |a - max|, as a factor exp of it) and expf's
            a64 = alpha.double()
            shift = torch.cat([torch.nan_to_num(exact[:, 0], neginf=0.0), a64.new_zeros(1)])
            d = a64 - shift[dst64]
            t = torch.exp(d)
            t_err = t * (torch.expm1(U_SUM * d.abs()) * (1 + EXPF_REL) + EXPF_REL)
            bound = sum_bound(t, g.dst, n, t_err)
            share = check_sum(f"softmax_stats {transport} ({e} edges)", got[:, 1], exact[:, 1],
                              bound)
            # the busiest 128-row block alone (every other block's range
            # empty): the time of the CTA that sets the call's
            hot = int(torch.argmax(torch.diff(bb)))
            hot_edges = int(bb[hot + 1] - bb[hot])
            only = torch.where(torch.arange(bb.numel(), device=dev) <= hot, bb[hot],
                               bb[hot + 1]).to(torch.int32)
            rows = slice(128 * hot, min(n, 128 * hot + 128))
            alone = sk.softmax_stats(alpha, g.dst, n, only)
            torch.cuda.synchronize()
            check(torch.equal(alone[rows, 0], plain[rows, 0]),
                  f"softmax_stats {transport}: the busiest block alone, max differs")
            check_sum(f"softmax_stats {transport} (busiest block alone)", alone[rows, 1],
                      exact[rows, 1], bound[rows])
            hot_ms = device_ms(lambda: sk.softmax_stats(alpha, g.dst, n, only))

            def lib():
                mx = torch.full((n + 1,), float("-inf"), device=dev).scatter_reduce_(
                    0, dst64, alpha, "amax")
                return torch.zeros(n + 1, device=dev).index_add_(
                    0, dst64, torch.exp(alpha - mx[dst64]))

            ms = device_ms(lambda: sk.softmax_stats(alpha, g.dst, n, bb))
            plain_ms = device_ms(lambda: sk.softmax_stats_plain(alpha, g.dst, n), reps=10)
            lib_ms = device_ms(lib)
            # every logit and id read once, the [N, 2] table written once;
            # a max, a subtract, an exp and an add per real edge
            nbytes, flops = 8 * e_pad + 8 * n, 4 * e
            b_ms, _ = bound_ms(nbytes, flops)
            print(f"softmax_stats {transport}: rows {n} edges {e} (padded {e_pad}) x{m} a "
                  f"forward; launches a call {launches}; sums vs float64 {rel:.3e} "
                  f"({share:.3f} of the rounding bound); ms {ms:.5f} plain_ms {plain_ms:.5f} "
                  f"library_ms {lib_ms:.5f} bound_ms {b_ms:.6f}; busiest block {hot} "
                  f"({hot_edges} edges) alone ms {hot_ms:.5f}", flush=True)
            check(launches == 1, f"softmax_stats {transport}: {launches} launches a call")
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                             ("library_ms", lib_ms), ("nbytes", nbytes), ("flops", flops)):
                agg[key] += m * val
        agg["bound_by"] = bound_ms(agg.pop("nbytes"), agg.pop("flops"))[1]
        results[("softmax", transport)] = agg

        # ---- K9, K10, K11 at the four streaming calls
        aggs = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, nbytes=0,
                        flops=0, library_ms=None)
                for k in ("stream_fwd", "stream_bwd_dst", "stream_bwd_src")}
        sweeps = {"stream_fwd": {}, "stream_bwd_dst": {}, "stream_bwd_src": {}}
        for _, g, chans, kz in stream:
            n_ch, n, e = len(chans), g.num_nodes, g.num_edges
            width, swidth = n_ch * (kz + 1), n_ch * (kz + 3)
            band = torch.cat([(0.5 * randn(n_ch, n, kz)).to(t_dtype),
                              randn(n_ch, n, 1).to(t_dtype)], dim=2)
            table = band.permute(1, 0, 2).reshape(n, width).contiguous()
            adst_r, mhat = fg.bound_shift(randn(n_ch, n), band[:, :, kz], 0.2, t_dtype)
            fargs = (table, adst_r, mhat, g.src, g.dst, n, kz)
            fkw = dict(block_bounds=g.block_bounds)
            acc = sg.stream_gat_fwd(*fargs, **fkw)
            acc_b = acc.view(n, n_ch, kz + 1)
            s = acc_b[:, :, kz].t()
            out = acc_b[:, :, :kz].permute(1, 0, 2) / (s[:, :, None] + 1e-16)
            gz = randn(n_ch, n, kz)
            stat = sg.stat_table(gz, (gz * out).sum(2), mhat + torch.log(s + 1e-16), adst_r,
                                 t_dtype)
            dargs = (table, stat, g.src, g.dst, n, kz)
            sargs = (table, stat, g.src_perm, g.src_sorted, g.dst, n, kz)
            # bytes: the stat bands' n_ch*(kz+3) values a row (not the
            # row padding), the ids, the outputs
            cases = (
                ("stream_fwd", sg.stream_gat_fwd, sg.stream_gat_fwd_plain, fargs, fkw,
                 n * width * (it + 4) + 2 * n_ch * n * 4 + 8 * e,
                 e * n_ch * (2 * (kz + 1) + 6)),
                ("stream_bwd_dst", sg.stream_gat_bwd_dst, sg.stream_gat_bwd_dst_plain, dargs,
                 dict(block_bounds=g.block_bounds),
                 n * (width + swidth) * it + 8 * e + n_ch * n * 4,
                 e * n_ch * (2 * kz + 14)),
                ("stream_bwd_src", sg.stream_gat_bwd_src, sg.stream_gat_bwd_src_plain, sargs,
                 dict(src_block_bounds=g.src_block_bounds),
                 n * (width + swidth) * it + 12 * e + n * width * 4,
                 e * n_ch * (4 * kz + 14)),
            )
            # the kernels take the graph's block bounds (kw); the plain
            # versions sum every real edge and read none
            for key, fn, plain, a, kw, nbytes, flops in cases:
                got = fn(*a, **kw)
                exact = plain(*a, acc_dtype=torch.float64)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), f"{key} {transport}: non-finite output")
                err, rel = rel_err(got.double(), exact)
                _, rel_plain = rel_err(got, plain(*a))
                check(rel <= KERNEL_TOL, f"{key} {transport} (n_ch {n_ch}, kz {kz}): "
                      f"relative error vs float64 {rel} > {KERNEL_TOL}")
                ms = device_ms(lambda: fn(*a, **kw))
                plain_ms = device_ms(lambda: plain(*a), reps=5)
                b_ms, b_by = bound_ms(nbytes, flops)
                print(f"{key} {transport}: n_ch {n_ch} kz {kz} rows {n} edges {e} (padded "
                      f"{g.dst.numel()}) rel_err vs float64 {rel:.3e} vs plain {rel_plain:.3e} "
                      f"ms {ms:.5f} plain_ms {plain_ms:.4f} bound_ms {b_ms:.5f} ({b_by}; "
                      f"{nbytes} bytes, {flops} flops)", flush=True)
                agg = aggs[key]
                agg["max_abs_err"] = max(agg["max_abs_err"], err)
                for k2, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                                ("nbytes", nbytes), ("flops", flops)):
                    agg[k2] += val
                if key in sweeps:
                    # the piece-size sweep: each size held to the float64 sums too
                    for piece in STREAM_PIECES:
                        got = fn(*a, piece_edges=piece, **kw)
                        _, rel = rel_err(got.double(), exact)
                        check(rel <= KERNEL_TOL, f"{key} {transport} pieces of {piece}: "
                              f"relative error vs float64 {rel} > {KERNEL_TOL}")
                        sweeps[key][piece] = sweeps[key].get(piece, 0.0) + device_ms(
                            lambda: fn(*a, piece_edges=piece, **kw))
            del acc, stat, table, out, exact, got
        for key, agg in aggs.items():
            agg["bound_by"] = bound_ms(agg.pop("nbytes"), agg.pop("flops"))[1]
            results[(key, transport)] = agg
        defaults = {"stream_fwd": sg.STREAM_FWD_PIECE_EDGES,
                    "stream_bwd_dst": sg.STREAM_DST_PIECE_EDGES,
                    "stream_bwd_src": sg.STREAM_SRC_PIECE_EDGES}
        for key, sweep in sweeps.items():
            print(f"{key} {transport}: (piece edges, ms of the 4 calls) "
                  f"{[(p, round(ms, 5)) for p, ms in sweep.items()]}; default "
                  f"{defaults[key]}", flush=True)
        torch.cuda.empty_cache()
    return results


def record_edge_calls(trainer):
    """{"gather": [(v, idx, n)], "segsum" / "scatter": [(rows, ids, n,
    order)]}: the arguments of every K7, K5 and K6 call (the wrappers'
    sk._gather and sk._sum_by_id) of one training step of `trainer` from
    init(2020), batch rows from a seeded generator."""
    from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk

    calls = {"gather": [], "segsum": [], "scatter": []}
    gather, sum_by_id = sk._gather, sk._sum_by_id

    def rec_gather(v, idx, n, *rest):
        calls["gather"].append((v.detach(), idx, n) + rest)
        return gather(v, idx, n, *rest)

    def rec_sum(counter, rows, ids, n, *rest):
        calls["segsum" if counter is sk.sorted_segment_sum else "scatter"].append(
            (rows.detach(), ids, n) + rest)
        return sum_by_id(counter, rows, ids, n, *rest)

    bs = trainer.tcfg.batch_size
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = trainer.init(2020)
    opt = trainer.optimizer(params)
    rows = torch.randint(0, trainer.n_rows, (bs,), generator=gen, device="cuda")
    sk._gather, sk._sum_by_id = rec_gather, rec_sum
    try:
        trainer.train_step(params, opt, rows, torch.ones(bs, device="cuda"), gen)
    finally:
        sk._gather, sk._sum_by_id = gather, sum_by_id
    torch.cuda.synchronize()
    return calls


def sum_alone(group):
    """A function that runs K5's or K6's recorded calls [(rows, ids, n,
    order)] straight through csrc/segment.cu's C entry: the kernel without
    the zeroing of its output, which the wrapper does a call.  The calls
    of one output shape share one output, zeroed once here, as the
    wrapper's calls get the same block back from the caching allocator
    (and find it in L2, where the zeroing left it); a separate output a
    call, out of L2, read up to 0.03 ms slower than the whole wrapper on
    one H100 (ML-25M K5 width 64, bf16).  The sums pile up; only the
    time is read.  (torch.profiler's kernel sums over such short replays
    came back empty for some groups on the card.)"""
    from graph_recsys_benchmark_tpu_torch.ops import _cuda
    from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk

    # the entry's row strides (ld_in, ld_out), which an older package's
    # entry (torch_tools/segment_edges.py on a parent) does not take
    strides = len(_cuda._SIGNATURES["scatter_add"][1]) == 13
    outs, args = {}, []
    for v, ids, n, order in group:
        d = v.shape[1]
        shape = (n, sk.acc_width(d))
        if shape not in outs:
            outs[shape] = torch.zeros(shape, dtype=torch.float32, device=v.device)
        perm, walk = order if order is not None else (None, ids)
        args.append((v.device, v.data_ptr(), int(v.dtype == torch.bfloat16),
                     None if perm is None else perm.data_ptr(), walk.data_ptr(),
                     outs[shape].data_ptr(), v.shape[0], n, d, shape[1])
                    + ((d, shape[1]) if strides else ()))

    def run():
        for a in args:
            _cuda.launch("scatter_add", *a)
    run.outs = outs  # kept alive with run
    return run


def id_runs(ids, n):
    """Mean edges an id takes, over the real edges (ids < n) of one call:
    (in runs of equal consecutive ids, among a 32-edge window's distinct
    ids, among a 2,048-edge chunk's, among the call's): what summing
    before the atomic can save at each reach.  For a block-monotone dst
    the last is the mean inside a 128-row block."""
    real = ids < n
    pos = torch.nonzero(real).flatten()
    r = ids[real].long()
    e = r.numel()
    if e == 0:
        return (0.0,) * 4, 0
    runs = 1 + int((r[1:] != r[:-1]).sum())

    def distinct(reach):
        return torch.unique((pos // reach) * (n + 1) + r).numel()

    return (e / runs, e / distinct(32), e / distinct(2048), e / torch.unique(r).numel()), e


def ml25m_edge_kernel_phase(trainers):
    """K7, K5 and K6 at the shapes one ML-25M training step gives them (the
    15 composed convs' gathers and sums and their backwards), per
    transport: the wrappers' calls of one step recorded (their arguments
    kept), then each kernel's calls replayed back to back, timed together
    (CUDA events: ms summed over the step's calls), beside the same calls
    of the plain versions and of one PyTorch call each (index_select from a
    table with a zero row for K7, index_add_ into a zeroed table with a
    sentinel row for K5 and K6, in the inputs' dtype) and the byte bound
    (edge_kernel_phase's counts).  Every call is held to its plain
    version: K7 bitwise, K5 and K6 row by row within sum_bound of the
    float64 sums.  Then per width group (the calls of one row width and
    dtype): their ms replayed back to back and bound ms, and for K5 and K6
    the kernel's own device time (sum_alone) and the mean edges an id
    takes (id_runs)."""
    from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk
    from graph_recsys_benchmark_tpu_torch.ops.segment import segment_sum

    results = {}
    gather, sum_by_id = sk._gather, sk._sum_by_id
    for transport, trainer in trainers.items():
        calls = record_edge_calls(trainer)
        for kind, recs in calls.items():
            err, nbytes, flops, shapes = 0.0, 0, 0, {}
            libs = []
            groups = {}  # (width, dtype) -> [call, bytes, runs, real edges]
            for rec in recs:
                v, ids, n = rec[:3]
                ids64 = torch.clamp(ids.long(), max=n)
                e, n_in = ids.numel(), int((ids < n).sum())
                if kind == "gather":
                    v2 = v.reshape(n, -1)
                    got, want = gather(*rec), sk.sorted_broadcast_plain(v, ids, n)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want), f"ml25m gather {transport}: not a bitwise "
                          f"copy at rows {n}, width {v2.shape[1]}")
                    row_bytes = v2.shape[1] * v2.element_size()
                    call_bytes, call_flops = e * 4 + n * row_bytes + e * row_bytes, 0
                    vpad = torch.cat([v2, v2.new_zeros(1, v2.shape[1])])
                    libs.append(lambda vpad=vpad, ids64=ids64: torch.index_select(vpad, 0,
                                                                                   ids64))
                    width, runs = v2.shape[1], None
                else:
                    counter = (sk.sorted_segment_sum if kind == "segsum"
                               else sk.localized_scatter_add)
                    if len(rec) > 3 and rec[3] is not None:  # the walk sums by its own ids
                        perm, walk = rec[3]
                        check(torch.equal(walk, ids[perm.long()]),
                              f"ml25m {kind} {transport}: a walk that is not ids[perm]")
                    got = sum_by_id(counter, *rec)
                    exact = segment_sum(v.double(), ids, n)
                    torch.cuda.synchronize()
                    check_sum(f"ml25m {kind} {transport} (rows {n}, width {v.shape[1]})", got,
                              exact, sum_bound(v.double(), ids, n))
                    err = max(err, rel_err(got.double(), exact)[0])
                    width = v.shape[1]
                    call_bytes = e * 4 + n_in * width * v.element_size() + n * width * 4
                    call_flops = n_in * width
                    libs.append(lambda v=v, ids64=ids64, n=n: torch.zeros(
                        n + 1, v.shape[1], dtype=v.dtype, device=v.device).index_add_(
                        0, ids64, v))
                    runs = id_runs(ids, n)
                nbytes += call_bytes
                flops += call_flops
                dtype = str(v.dtype).split(".")[-1]
                key = (n, width, dtype, e)
                shapes[key] = shapes.get(key, 0) + 1
                grp = groups.setdefault((width, dtype), [[], 0, 0, [0.0] * 4, 0])
                grp[0].append(rec)
                grp[1] += call_bytes
                grp[2] += call_flops
                if runs is not None:
                    grp[3] = [a + b * runs[1] for a, b in zip(grp[3], runs[0])]
                    grp[4] += runs[1]
            counter = {"gather": None, "segsum": sk.sorted_segment_sum,
                       "scatter": sk.localized_scatter_add}[kind]

            def replay(group):
                if kind == "gather":
                    def run():
                        for rec in group:
                            gather(*rec)
                else:
                    def run():
                        for rec in group:
                            sum_by_id(counter, *rec)
                return run

            if kind == "gather":
                def plain():
                    for v, ids, n, *_ in recs:
                        sk.sorted_broadcast_plain(v, ids, n)
            else:
                def plain():
                    for v, ids, n, *_ in recs:
                        sk.sorted_segment_sum_plain(v, ids, n, "f32")

            def lib():
                for f in libs:
                    f()

            ms = device_ms(replay(recs), reps=10)
            plain_ms = device_ms(plain, reps=3)
            lib_ms = device_ms(lib, reps=10)
            b_ms, b_by = bound_ms(nbytes, flops)
            print(f"ml25m {SEG_KERNELS[kind]} {transport}: {len(recs)} calls in one step "
                  f"((rows, width, dtype, edges) x calls: "
                  f"{sorted(shapes.items(), key=lambda kv: -kv[1])}); ms {ms:.5f} plain_ms "
                  f"{plain_ms:.4f} library_ms {lib_ms:.5f} bound_ms {b_ms:.5f} ({b_by}; "
                  f"{nbytes} bytes)", flush=True)
            for (width, dtype), (group, g_bytes, g_flops, run_sum, run_e) in sorted(
                    groups.items(), key=lambda kv: -kv[1][1]):
                g_ms = device_ms(replay(group), reps=10)
                g_bound = bound_ms(g_bytes, g_flops)[0]
                line = (f"ml25m {SEG_KERNELS[kind]} {transport} width {width} {dtype}: "
                        f"{len(group)} calls ms {g_ms:.5f} bound_ms {g_bound:.5f} (share "
                        f"{g_bound / g_ms:.3f})")
                if kind != "gather":
                    k_ms = device_ms(sum_alone(group), reps=10)
                    line += (f"; kernel alone {k_ms:.5f} ms, zeroing {g_ms - k_ms:.5f} ms; "
                             "mean edges an id takes (run, 32-edge window, 2,048-edge "
                             f"chunk, call) {[round(x / run_e, 3) for x in run_sum]}")
                print(line, flush=True)
            results[(kind, transport)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                              bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                                              calls=len(recs))
        del calls
        torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def plain_on_card():
    """Every kernel of the ML-25M path and of the flagship's GAT routes
    replaced by its plain PyTorch version for CUDA tensors too, for this
    script's oracle runs only: the wrappers' own rule (a CUDA tensor
    launches the kernel or raises) is untouched outside the block.  Plain
    versions count no launches."""
    from graph_recsys_benchmark_tpu_torch.ops import batch_gat as bg
    from graph_recsys_benchmark_tpu_torch.ops import flash_gat as fg
    from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk
    from graph_recsys_benchmark_tpu_torch.ops import stream_gat as sg

    swaps = [
        (fg, "flash_gat_fwd", fg.flash_gat_fwd_plain),  # K1, K12
        (fg, "gat_rowmax", fg.gat_rowmax_plain),  # K12-online
        (fg, "flash_gat_fwd_online", fg.flash_gat_fwd_plain),
        (fg, "flash_gat_bwd", fg.flash_gat_bwd_plain),  # K2
        (fg, "flash_gat_bwd_glue", fg.flash_gat_bwd_glue_plain),  # K13
        (fg, "flash_gat_bwd_onepass", fg.flash_gat_bwd_onepass_plain),  # K14
        (bg, "batch_gat_fwd", bg.batch_gat_fwd_plain),  # K3
        (bg, "batch_gat_bwd", bg.batch_gat_bwd_plain),  # K4
        (sk, "_gather", lambda v, idx, n: sk.sorted_broadcast_plain(v, idx, n)),  # K7
        (sk, "_sum_by_id", lambda counter, rows, ids, n, order=None:  # K5, K6
         sk.sorted_segment_sum_plain(rows, ids, n, "f32")),
        # K8-K11: the plain versions read no block bounds
        (sk, "softmax_stats", lambda *a: sk.softmax_stats_plain(*a[:3])),  # K8
        (sg, "stream_gat_fwd", lambda *a, block_bounds: sg.stream_gat_fwd_plain(*a)),  # K9
        (sg, "stream_gat_bwd_dst", lambda *a, block_bounds: sg.stream_gat_bwd_dst_plain(*a)),
        (sg, "stream_gat_bwd_src",
         lambda *a, src_block_bounds: sg.stream_gat_bwd_src_plain(*a)),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def ml25m_phase(trainer, stream, composed):
    """Per transport: one step's launches, one step's loss and gradients
    against the plain versions on the card, 2 warm-up and 8 timed steps
    (counts over them), a profiled step, one evaluation (launches, forward
    against the plain versions, wall, metrics)."""
    from graph_recsys_benchmark_tpu_torch.models.pea import pea_loss

    transport, cfg = trainer.transport, trainer.cfg
    label = f"ml25m {transport}"
    bs, n_rows = trainer.tcfg.batch_size, trainer.n_rows
    n_s, n_c = len(stream), len(composed)
    fwd = dict(stream_fwd=n_s, softmax=n_c, gather=3 * n_c, segsum=n_c)
    step = dict(fwd, stream_bwd_dst=n_s, stream_bwd_src=n_s, gather=5 * n_c,
                segsum=3 * n_c, scatter=n_c)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def uniform_rows():
        return torch.randint(0, n_rows, (bs,), generator=gen, device="cuda")

    mask = torch.ones(bs, device="cuda")
    # ---- one step's launch counts
    params = trainer.init(2020)
    opt = trainer.optimizer(params)
    reset_launches()
    trainer.train_step(params, opt, uniform_rows(), mask, gen)
    torch.cuda.synchronize()
    step_launches = read_launches()
    check(step_launches == expected(**step),
          f"{label} step: launches {step_launches}, expected {step}")

    # ---- one step's loss and gradients against the plain versions on the card
    params = trainer.init(2020)
    with torch.no_grad():
        params.x.mul_(10.0)
        params.fc1["b"].mul_(0.1)
    plain_params = copy.deepcopy(params)
    batch = trainer._build_batch(uniform_rows(), gen)
    rmask = (torch.arange(bs, device="cuda") < bs - 300).float()  # a partial batch
    loss = trainer.batch_loss(params, batch, rmask)
    loss.backward()
    with plain_on_card():
        plain_loss = pea_loss(plain_params, trainer.graphs, cfg, batch, row_mask=rmask,
                              transport=transport)
        plain_loss.backward()
    torch.cuda.synchronize()
    tol = FORWARD_TOL[transport]
    check(bool(torch.isfinite(loss)), f"{label}: loss {float(loss)} not finite")
    _, rel = rel_err(loss.detach(), plain_loss.detach())
    check(rel <= tol, f"{label} step loss vs plain: relative error {rel} > {tol}")
    errs = leaf_errors(label, params, plain_params)
    median, worst = errs[len(errs) // 2], errs[-1]
    check(median[0] <= tol and worst[0] <= KINK_TOL,
          f"{label} grads vs plain: median {median} > {tol} or worst {worst} > {KINK_TOL}")
    print(f"train {label}: one step launches {step_launches}; loss {float(loss):.6f} vs plain "
          f"on the card {float(plain_loss):.6f} (rel {rel:.3e}); gradients vs plain: median "
          f"{median[1]} rel {median[0]:.3e}, worst {worst[1]} rel {worst[0]:.3e}, "
          f"{sum(e > tol for e, _ in errs)} of {len(errs)} over {tol}", flush=True)
    del plain_params, plain_loss, loss

    # ---- 2 warm-up steps, then 8 timed steps, the counts read over them
    params = trainer.init(2020)
    opt = trainer.optimizer(params)
    for _ in range(2):
        trainer.train_step(params, opt, uniform_rows(), mask, gen)
    rows = [uniform_rows() for _ in range(8)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses = [trainer.train_step(params, opt, r, mask, gen) for r in rows]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    check(launches == expected(**{k: 8 * v for k, v in step.items()}),
          f"{label}: launches over 8 steps {launches}")
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"{label}: step losses {losses}")
    step_ms = secs / 8 * 1e3
    print(f"train {label}: 8 timed steps of {bs} (after 2 warm-up; rows drawn uniformly from "
          f"{n_rows}); step ms {step_ms:.4f}; train examples/s {8 * bs / secs:.1f}; losses "
          f"{[round(x, 4) for x in losses]}; launches over the 8 steps {launches}", flush=True)
    device_breakdown(lambda: trainer.train_step(params, opt, uniform_rows(), mask, gen),
                     f"train step {label}", step_ms)
    matmul_shapes(lambda: trainer.train_step(params, opt, uniform_rows(), mask, gen),
                  f"train step {label}")

    # ---- one evaluation: launches, forward against the plain versions
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.evaluate(params, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    eval_launches = read_launches()
    check(eval_launches == expected(**fwd), f"{label} eval: launches {eval_launches}, "
          f"expected {fwd}")
    for k in ("HR", "NDCG", "AUC", "eval_loss"):
        check(bool(torch.isfinite(res[k]).all()), f"{label} eval: {k} not finite")
    auc = float(res["AUC"])
    check(0.0 <= auc <= 1.0, f"{label}: AUC {auc}")
    with torch.no_grad():
        rep = trainer.eval_forward(params)
        with plain_on_card():
            plain_rep = trainer.eval_forward(params)
    check(rep.shape == (cfg.num_nodes, cfg.repr_dim) and bool(torch.isfinite(rep).all()),
          f"{label}: repr shape {tuple(rep.shape)} or not finite")
    _, fwd_rel = rel_err(rep, plain_rep)
    check(fwd_rel <= FORWARD_TOL[transport],
          f"{label} forward vs plain: relative error {fwd_rel}")
    walls = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.evaluate(params, torch.Generator(device="cuda").manual_seed(i + 1))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    print(f"eval {label}: {trainer.tables.test_users.numel()} users x (1 + "
          f"{trainer.tcfg.num_neg_candidates}); launches {eval_launches}; HR@10 "
          f"{float(res['HR'][5]):.4f} NDCG@10 {float(res['NDCG'][5]):.4f} AUC {auc:.4f} "
          f"(after 11 steps); repr vs plain rel {fwd_rel:.3e}; wall ms first {first_ms:.3f}, "
          f"median of 3 {wall:.4f} runs {[round(w, 3) for w in walls]}", flush=True)
    device_breakdown(lambda: trainer.evaluate(
        params, torch.Generator(device="cuda").manual_seed(99)), f"eval {label}", wall)
    return dict(launches=launches, eval_launches=eval_launches)


# the published recipe (JAX cli.py:47-54 defaults: 5 runs x 30 epochs, batch
# 1,024, f32, Adam) and the JAX run it is held against
RECIPE = ["--model", "PEAGAT", "--dataset", "synthetic-ml", "--entity_aware", "true"]
JAX_RECIPE = "runs/recipe_a2a_r5/ml-synthetic/PEAGAT/eeae2acefb9d/logger_file.txt:161"
JAX_HR10, JAX_AUC = 0.3320, 0.7452
# chip_smoke.py fails outside this band of the overall HR@10: +-0.05 around the
# JAX run's 0.3320, over four standard errors of a five-run mean of 150-user
# hit rates, and far above a random scorer's 0.10
HR_BAND = (0.28, 0.38)
WIDE = 300  # a row width past the edge kernels' MAX_COLS (256 columns a launch)


def _plan_launches(trainer):
    """(a forward's, a backward's) launches of a PEAGAT trainer's hybrid plan:
    one flash pass a step with a union graph, one batched pass a share."""
    steps = trainer.graphs.steps
    u = sum(union is not None for _, union, _ in steps)
    b = sum(len(batched) for batched, _, _ in steps)
    return dict(flash_fwd=u, batch_fwd=b), dict(flash_bwd=u, batch_bwd=b)


def _predict(fwd, bwd, steps, forwards):
    """Every wrapper's launches over `steps` training steps (a forward and a
    backward each) and `forwards` evaluation forwards."""
    counts = {k: v * (steps + forwards) for k, v in fwd.items()}
    counts.update({k: v * steps for k, v in bwd.items()})
    return expected(**counts)


def _log_lines(out_root):
    (path,) = [os.path.join(d, "logger_file.txt") for d, _, fs in os.walk(out_root)
               if "logger_file.txt" in fs]
    with open(path) as f:
        return path, f.read().splitlines()


def _near_tie_users(users, tables, score):
    """For each test user index in `users` (dense tables), the smallest gap
    |s(candidate) - s(positive)| / |s(positive)| over its unseen items."""
    gaps = []
    for k in users:
        u, p = tables.test_users[k:k + 1], tables.test_items[k:k + 1]
        cand = tables.cand[k, 1:1 + int(tables.neg_counts[k])]
        s_pos = score(u, p)
        s_c = score(u.repeat(cand.numel()), cand)
        gaps.append(float(((s_c - s_pos).abs() / s_pos.abs().clamp_min(1e-30)).min()))
    return gaps


def cli_phase(tmp, recipe_extra=()):
    """The port's CLI (cli.main, in process) on the card, each call with every
    launch count set to 0 just before and read just after:
    a. the published recipe (RECIPE, 5 runs x 30 epochs): launches against the
       plan's prediction, each run's initial and best HR@10 (the best above
       the initial), the overall HR@10 in HR_BAND, NDCG@10, AUC, the wall
       seconds and seconds an epoch;
    b. --epochs 2 --save_every_epoch 0 with --runs 1, then --runs 2 into the
       same run directory: run 1 is not trained again, run 2 is; run 2's
       latest checkpoint loads onto the card bitwise equal to the file;
    c. bf16 transport, 1 run x 2 epochs with the metapath ablation and the
       full-catalog ranking: launches over the call, then evaluate_full on
       the run's checkpoint (the forward's launches and no more) and its
       ranks against the same ranking over a CPU copy of the cached
       representation (a user may differ only where its positive's score
       lies within 1e-5, relative, of a candidate's);
    d. PEAGCN at --hidden_size 300 per transport, 1 run x 1 epoch (K5 and K6
       at 300 columns on step 1 in two passes a call, K7 in one launch), then
       edge_cases on the same configuration's step-1 union graph at 300
       columns (its seconds printed);
    e. python -m graph_recsys_benchmark_tpu_torch as a subprocess, 1 run x 1
       epoch: exit 0 and the Overall line.
    recipe_extra: arguments added to every call (none on the card)."""
    from graph_recsys_benchmark_tpu_torch import cli
    from graph_recsys_benchmark_tpu_torch.eval.full_ranking import evaluate_full_ranking
    from graph_recsys_benchmark_tpu_torch.models.pea import pea_predict
    from graph_recsys_benchmark_tpu_torch.train.sampling import build_device_tables
    from graph_recsys_benchmark_tpu_torch.utils.checkpoint import load_checkpoint

    extra = list(recipe_extra)
    cache = os.path.join(tmp, "cache")

    def argv_of(argv, out):
        return list(argv) + extra + ["--out_dir", os.path.join(tmp, out), "--cache_dir", cache]

    def trainer_of(argv, out):
        """The trainer and HIN that cli.main builds for these arguments."""
        args = cli.build_parser().parse_args(argv_of(argv, out))
        hin, mp_edges = cli.load_hin(args)
        return cli.build_trainer(args, hin, mp_edges)[0], hin

    def run(argv, out):
        full = argv_of(argv, out)
        print(f"cli: main({' '.join(full)})", flush=True)
        reset_launches()
        t0 = time.perf_counter()
        overall = cli.main(full)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        path, lines = _log_lines(os.path.join(tmp, out))
        return overall, launches, wall, path, lines

    out = {}
    # a. the recipe
    trainer, hin = trainer_of(RECIPE, "recipe")
    check(trainer.device.type == "cuda", f"the CLI's trainer is on {trainer.device}")
    fwd, bwd = _plan_launches(trainer)
    runs, epochs, s = trainer.tcfg.runs, trainer.tcfg.epochs, trainer.num_batches
    overall, launches, wall, path, lines = run(RECIPE, "recipe")
    want = _predict(fwd, bwd, runs * epochs * s, runs * (epochs + 1))
    check(launches == want, f"recipe launches {launches}, predicted {want}")
    inits = [float(re.search(r"HR@10: ([0-9.]+)", ln).group(1)) for ln in lines
             if ln.startswith("Initial performance")]
    done = [re.search(r"Duration: ([0-9.]+)s, best HR@10: ([0-9.]+)", ln).groups()
            for ln in lines if ", Duration: " in ln]
    check(len(inits) == runs and len(done) == runs, f"recipe log {path}: {len(inits)} "
          f"initial and {len(done)} run lines for {runs} runs")
    bests = [float(b) for _, b in done]
    for r, (i, b) in enumerate(zip(inits, bests), start=1):
        check(b > i, f"recipe run {r}: best HR@10 {b} not above its initial {i}")
    hr10, ndcg10 = float(overall["HR"][5]), float(overall["NDCG"][5])
    auc = float(np.ravel(overall["AUC"])[0])
    check(HR_BAND[0] <= hr10 <= HR_BAND[1], f"recipe overall HR@10 {hr10} outside {HR_BAND}")
    run_s = [float(d) for d, _ in done]
    print(f"recipe ({hin.name}: {hin.num_nodes} nodes, {hin.num_users} test users, "
          f"{hin.train_pos.shape[0]} train interactions, {s} steps an epoch; {runs} runs x "
          f"{epochs} epochs): initial HR@10 {inits} best HR@10 {bests} overall HR@10 "
          f"{hr10:.4f} NDCG@10 {ndcg10:.4f} AUC {auc:.4f} (JAX {JAX_RECIPE}: HR@10 "
          f"{JAX_HR10}, AUC {JAX_AUC}; HR@10 {hr10 - JAX_HR10:+.4f}, AUC "
          f"{auc - JAX_AUC:+.4f}); wall {wall:.2f} s, runs {run_s} s, "
          f"{sum(run_s) / (runs * epochs):.4f} s an epoch; launches {launches}", flush=True)
    out["recipe"] = dict(hr10=hr10, ndcg10=ndcg10, auc=auc, wall=wall, launches=launches)

    # b. run-level resume: --runs 1, then --runs 2 in the same run directory
    base = RECIPE + ["--epochs", "2", "--save_every_epoch", "0"]
    o1, _, _, path1, _ = run(base + ["--runs", "1"], "resume")
    o2, l2, _, path2, lines2 = run(base + ["--runs", "2"], "resume")
    check(path1 == path2, f"resume: {path2} is not {path1}")
    trained = [ln for ln in lines2 if ", epoch: " in ln and "exclude" not in ln]
    check([ln.split(",")[0] for ln in trained] == ["Run: 1"] * 2 + ["Run: 2"] * 2,
          f"resume: epoch lines {trained}")
    want = _predict(fwd, bwd, 2 * s, 3)  # run 2 alone: its init eval and 2 epochs
    check(l2 == want, f"resume launches {l2}, predicted {want}")
    with np.load(os.path.join(os.path.dirname(path2), "global_logger.npz")) as g:
        check(g["HR"].shape[0] == 2 and np.array_equal(g["HR"][0], o1["HR"]),
              "resume: run 1's summary row changed")
    ckpt = os.path.join(os.path.dirname(path2), "run_2", "latest.ckpt")
    params = trainer.init(0)
    opt = trainer.optimizer(params)
    load_checkpoint(ckpt, params, opt)
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    for k, v in params.state_dict().items():
        check(v.device.type == "cuda" and torch.equal(v.cpu(), saved["params"][k]),
              f"resume: {k} not on the card or not the checkpoint's")
    for st in opt.state_dict()["state"].values():
        check(st["exp_avg"].device.type == "cuda", "resume: Adam's moments not on the card")
    print(f"resume: run 1 kept (HR@10 {float(o1['HR'][5]):.4f}), run 2 trained; overall "
          f"HR@10 {float(o2['HR'][5]):.4f}; launches {l2}; run 2's latest checkpoint "
          f"(epoch {saved['epoch']}) loaded onto the card bitwise", flush=True)

    # c. bf16, the ablation and the full-catalog ranking
    bf = RECIPE + ["--message_dtype", "bf16", "--runs", "1", "--epochs", "2",
                   "--save_every_epoch", "0", "--metapath_test", "true", "--full_ranking", "true"]
    tb, hin = trainer_of(bf, "bf16")
    n_mp = tb.cfg.num_channels
    ob, lb, wall_b, path_b, lines_b = run(bf, "bf16")
    want = _predict(fwd, bwd, 2 * s, 1 + 2 + 2 * n_mp + 1)
    check(lb == want, f"bf16 launches {lb}, predicted {want}")
    check(sum("exclude path:" in ln for ln in lines_b) == 2 * n_mp
          and sum(", full-ranking HR@10" in ln for ln in lines_b) == 1,
          "bf16: the ablation or full-ranking lines are missing")
    params = tb.init(0)
    load_checkpoint(os.path.join(os.path.dirname(path_b), "run_1", "latest.ckpt"), params,
                    tb.optimizer(params))
    reset_launches()
    full = tb.evaluate_full(params)
    torch.cuda.synchronize()
    lf = read_launches()
    check(lf == expected(**fwd), f"evaluate_full launches {lf}, expected the forward's {fwd}")
    check(tb.tables.mode == "dense", "the near-tie check reads dense tables")
    with torch.no_grad():
        rep = tb.eval_forward(params, torch.ones(n_mp, device=tb.device))
        ranks = evaluate_full_ranking(
            lambda u, i: pea_predict(params, rep, u.long(), i.long()), tb.tables)["ranks"]
        p_cpu, rep_cpu = copy.deepcopy(params).cpu(), rep.cpu()

        def score_cpu(u, i):
            return pea_predict(p_cpu, rep_cpu, u.long(), i.long())

        tables_cpu = build_device_tables(hin, "cpu")
        ranks_cpu = evaluate_full_ranking(score_cpu, tables_cpu)["ranks"]
        differ = torch.nonzero(ranks.cpu() != ranks_cpu).flatten().tolist()
        gaps = _near_tie_users(differ, tables_cpu, score_cpu)
    check(all(g <= 1e-5 for g in gaps),
          f"full ranking: users {differ} rank apart on the card and the CPU, gaps {gaps}")
    print(f"bf16 call: overall HR@10 {float(ob['HR'][5]):.4f}, wall {wall_b:.2f} s, launches "
          f"{lb}; evaluate_full HR@10 {float(full['HR'][5]):.4f} NDCG@10 "
          f"{float(full['NDCG'][5]):.4f}, launches {lf}; ranks on the card vs a CPU copy: "
          f"{len(differ)} of {ranks.numel()} users differ (near ties {gaps})", flush=True)

    # d. PEAGCN with 300-column rows on step 1
    out["wide"], out["wide_steps"] = {}, {}
    for t in TDT:
        wide = ["--model", "PEAGCN", "--hidden_size", str(WIDE), "--runs", "1", "--epochs",
                "1", "--init_eval", "false", "--message_dtype", t]
        tw, _ = trainer_of(wide, f"wide-{t}")
        sw = tw.num_batches
        ow, lw, wall_w, _, _ = run(wide, f"wide-{t}")
        # K5 and K6 take two passes at 300 columns, one at repr 16; K7 one
        # launch at either: a step gathers twice (the forward and K5's
        # backward), sums once and scatters once (K7's backward) a conv
        # step; the eval after the epoch gathers and sums once a conv step
        want = expected(gather=4 * sw + 2, segsum=3 * sw + 3, scatter=3 * sw)
        check(lw == want, f"PEAGCN hidden {WIDE} {t}: launches {lw}, predicted {want}")
        check(all(np.isfinite(v).all() for v in ow.values()), f"PEAGCN {WIDE} {t}: not finite")
        print(f"PEAGCN hidden {WIDE} {t}: HR@10 {float(ow['HR'][5]):.4f}, wall {wall_w:.2f} s, "
              f"launches {lw} ({sw} steps and one eval)", flush=True)
        out["wide"][t], out["wide_steps"] = lw, sw
    # K5, K7 and K6 at the shapes that call gave them on step 1
    t0 = time.perf_counter()
    out["wide_kernels"] = {}
    edge_cases(tw.graphs[0], WIDE, f"PEAGCN --hidden_size {WIDE} step 1", "gcn-wide",
               np.random.default_rng(1), out["wide_kernels"])
    print(f"edge kernels at {WIDE} columns {time.perf_counter() - t0:.1f} s", flush=True)

    # e. the entry point as a user runs it
    cmd = [sys.executable, "-m", "graph_recsys_benchmark_tpu_torch"] + argv_of(
        RECIPE + ["--runs", "1", "--epochs", "1"], "module")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0 and "Overall HR@10:" in proc.stdout,
          f"python -m graph_recsys_benchmark_tpu_torch: exit {proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    last = [ln for ln in proc.stdout.splitlines() if ln.startswith("Overall")]
    print(f"python -m graph_recsys_benchmark_tpu_torch: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s; {last[-1]}", flush=True)
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
    ptxas_summary(logs)

    t0 = time.perf_counter()
    hin, all_trainers = build_flagship()
    trainers = all_trainers["gat"]
    cfg = trainers["f32"].cfg
    plan = trainers["f32"].graphs
    (b1, union, rest), (shares, u2, _) = plan.steps
    check(len(b1) == 0 and len(rest) == 9 and u2 is None, "step-1 plan: expected one 9-channel union")
    check([c for _, c in shares] == [(0, 2, 3, 4, 5, 6, 7), (1, 8)],
          f"step-2 plan: shares {[c for _, c in shares]}")
    print(f"flagship: {hin.num_nodes} nodes, {hin.train_pos.shape[0]} train interactions, "
          f"{hin.candidates.cand.shape[0]} test users (candidates {hin.candidates.cand.shape}); "
          f"step 1 union {len(rest) * hin.num_nodes} rows {union.num_edges} edges "
          f"(padded {union.dst.numel()}); step 2 shares "
          f"{[(c, g.num_edges, g.dst.numel()) for g, c in shares]}; PEAGCN / PEASage "
          f"union graphs (rows, edges, padded): "
          f"{[(c, [(g.num_nodes, g.num_edges, g.dst.numel()) for g in all_trainers[c]['f32'].graphs]) for c in ('gcn', 'sage')]}"
          f"; host build {time.perf_counter() - t0:.1f} s", flush=True)

    def timed(label, fn, *args, **kw):
        t = time.perf_counter()
        res = fn(*args, **kw)
        print(f"{label} phase {time.perf_counter() - t:.1f} s", flush=True)
        return res

    kres = timed("GAT kernel", kernel_phase, plan, hin.num_nodes)
    eres = timed("edge kernel", edge_kernel_phase, all_trainers)
    sres = timed("PEAGAT eval", slice_phase, cfg, trainers)
    tres = timed("PEAGAT training", train_phase, hin, cfg, trainers)
    fres = {"gcn": timed("PEAGCN", fused_phase, hin, all_trainers["gcn"], epochs=2),
            "sage": timed("PEASage", fused_phase, hin, all_trainers["sage"], epochs=1)}
    t_modes = time.perf_counter()
    mkres_modes = mode_kernel_phase(plan, hin.num_nodes)
    mres_modes = mode_slice_phase(hin, cfg, trainers)
    print(f"flash-GAT mode phases {time.perf_counter() - t_modes:.1f} s", flush=True)
    del hin, all_trainers, trainers, plan, union
    torch.cuda.empty_cache()

    t_m = time.perf_counter()
    hin25, trainers25 = build_ml25m()
    stream, composed = ml25m_describe(hin25, trainers25["f32"])
    mkres = ml25m_kernel_phase(trainers25["f32"], stream, composed)
    meres = ml25m_edge_kernel_phase(trainers25)
    mres = {t: ml25m_phase(trainers25[t], stream, composed) for t in TDT}
    for (kind, transport), r in meres.items():
        steps = mres[transport]["launches"][kind] / 8
        check(r["calls"] == steps, f"ml25m {kind} {transport}: {r['calls']} calls recorded "
              f"in one step, {steps} launches a timed step")
    print(f"ml25m phases {time.perf_counter() - t_m:.1f} s (earlier phases "
          f"{t_m - t_start:.1f} s)", flush=True)
    del hin25, trainers25
    torch.cuda.empty_cache()

    t_c = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cres = cli_phase(tmp)
    print(f"cli phases {time.perf_counter() - t_c:.1f} s", flush=True)

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
    replaces = {"segsum": "77", "gather": "426", "scatter": "636"}
    path = {"gcn": "PEAGCN steps 1+2", "sage": "PEASage steps 1+2",
            "gcn-wide": f"the CLI's PEAGCN --hidden_size {WIDE} step 1, launches over its "
                        f"{cres['wide_steps']} steps and one eval"}
    for (kind, conv, transport), r in list(eres.items()) + list(cres["wide_kernels"].items()):
        # the path's last timed epoch; at 300 columns the CLI's call, whose
        # graph edge_cases measured
        launches = (cres["wide"][transport][kind] if conv == "gcn-wide"
                    else fres[conv][transport]["launches"][kind])
        kernels.append(dict(
            name=f"{SEG_KERNELS[kind]} ({transport}; {path[conv]}: {' + '.join(r['shapes'])})",
            route="cuda", source=f"{csrc}/segment.cu",
            replaces=f"{repo}/ops/pallas_segment.py:{replaces[kind]}",
            launches=launches, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    replaces = {"softmax": ("pallas_segment.py:244", "segment.cu", "softmax_stats",
                            "15 composed convs of one forward"),
                "stream_fwd": ("stream_gat.py:220", "stream_gat.cu", "stream_gat_fwd",
                               "4 calls of one forward"),
                "stream_bwd_dst": ("stream_gat.py:292", "stream_gat.cu",
                                   "stream_gat_bwd_dst", "4 calls of one backward"),
                "stream_bwd_src": ("stream_gat.py:364", "stream_gat.cu",
                                   "stream_gat_bwd_src", "4 calls of one backward")}
    for (kind, transport), r in mkres.items():
        where, src_file, name, calls = replaces[kind]
        kernels.append(dict(
            name=f"{name} ({transport}; ML-25M, {calls})", route="cuda",
            source=f"{csrc}/{src_file}", replaces=f"{repo}/ops/{where}",
            # the 8 timed ML-25M steps
            launches=mres[transport]["launches"][kind], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    replaces = {"segsum": "77", "gather": "426", "scatter": "636"}
    for (kind, transport), r in meres.items():
        kernels.append(dict(
            name=f"{SEG_KERNELS[kind]} ({transport}; ML-25M, {r['calls']} calls of one step)",
            route="cuda", source=f"{csrc}/segment.cu",
            replaces=f"{repo}/ops/pallas_segment.py:{replaces[kind]}",
            # the 8 timed ML-25M steps
            launches=mres[transport]["launches"][kind], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    # the variant routes: a forward's launches are its mode's eval's, a
    # backward's the mode's MODE_STEPS steps'
    modes = {"rowmax": ("online-fused", "eval_launches", "gat_fwd.cu", "129",
                        "gat_rowmax (K12-online pass 1, the row max"),
             "flash_fwd_online": ("online-fused", "eval_launches", "gat_fwd.cu", "129",
                                  "flash_gat_fwd_online (K12-online pass 2, the walk"),
             "flash_bwd_glue": ("bound-glue", "launches", "gat_bwd.cu", "829",
                                "flash_gat_bwd_glue (K13"),
             "scatter_glue": ("bound-glue", "launches", "segment.cu", None,
                              "localized_scatter_add (K6 on K13's rows"),
             "flash_bwd_onepass": ("bound-onepass", "launches", "gat_bwd.cu", "1079",
                                   "flash_gat_bwd_onepass (K14")}
    for (kind, transport), r in mkres_modes.items():
        mode, runs, src_file, line, name = modes[kind]
        counter = "scatter" if kind == "scatter_glue" else kind
        replaces = (f"{repo}/ops/pallas_segment.py:636" if line is None
                    else f"{repo}/ops/flash_gat.py:{line}")
        kernels.append(dict(
            name=f"{name}; {transport}; union kz 64, mode {mode})", route="cuda",
            source=f"{csrc}/{src_file}", replaces=replaces,
            launches=mres_modes[(mode, transport)][runs][counter],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
