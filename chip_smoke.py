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
   c. dropout_phase, f32: PEAGAT with attention dropout 0.1, one step's
      loss and every gradient on the card against a CPU copy under the same
      keep masks (drawn once on the CPU, models/pea.DropoutMasks.to),
      train_phase's rules with kink_rows; the step's launches those of the
      per-channel route (18 composed convs: K8 18, K7 90, K5 54, K6 18; no
      K1-K4).
   d. per_channel_phase, the per-channel forwards at the flagship's full
      width and depth, per transport: PEAGCN, PEASage and PEAGAT on the
      mixed table (meta_path_steps (1,) + (2,) * 8, channel 0 its first
      step only: 17 convs) and PEAGCN, PEASage with fused=False on the
      uniform table (18 convs), each on its trainer's per-channel graphs:
      an eval forward's and a step's launches against
      per_channel_launches (the code's count: a GCN/SAGE conv K7 2, K5 1,
      K6 1 a step; a composed GAT conv of H heads K7 3 + 2H, K8 H, K5 2 +
      H, K6 1), two steps on one batch (the loss falls), one step against
      the plain versions on the card and a CPU copy (step_vs_references:
      the loss and the median leaf within the CPU tests' bars PC_TOL /
      PC_MEDIAN, every leaf KINK_TOL); on the mixed table each K7, K5, K6
      call of a step replayed against its plain version and timed
      (ml25m_edge_kernel_phase) and, for PEAGAT, each K8 call
      (softmax_calls_phase). Then ROADMAP Queue 3's card checks, PEAGAT
      per transport, one step each against plain_on_card with its
      launches: num_heads 2 on the hybrid plan (K12 2, K3 2, K2 2, K4 2)
      and on the mixed table, channel_aggr 'mean' and 'concat'.
   e. profiling_phase, one flagship PEAGAT step per transport: in f32 a
      utils/profiling.trace (a StepTimer range around the step) whose
      trace file must list gat_fwd_walk_kernel and gat_bwd_walk_kernel;
      utils/roofline.count_cost of the step (aten ops and the kernel
      wrappers' declared terms), profiling.timed (20 steps after 3) and
      roofline_report: hbm_util and mfu each in (0, 1], printed beside the
      card's name and power limit.
   f. baselines_phase, the graph baselines on the flagship HIN at the
      CLI's published widths (emb 64, hidden 64: convs 64 -> 64 -> 32 ->
      16) and TrainConfig's defaults: NGCF, KGAT, KGCN per transport, CFKG
      and NFM in f32. K7, K5 and K6 at the NGCF graph's (143,842 edges)
      and the KG graph's (164,048 edges, 8 relations and their reverses)
      shapes, D 64 and 32, per transport (edge_cases), and K8 on the KG
      graph at KGAT's and KGCN's attention logits (check_softmax), each
      with its device, plain and library ms and its bound; per model one
      step (KGAT/KGCN: a CF step under the attention snapshot) against
      plain_on_card and a CPU copy (loss and median leaf within PC_TOL /
      PC_MEDIAN, every leaf KINK_TOL; NFM's new BatchNorm statistics; the
      attention map within 1e-5); one step's and one eval's launches
      against the code's count (an NGCF step K7 9, K5 6, K6 3; a KG CF
      step K7 6, K5 3, K6 3; an attention snapshot K8 1, K7 1; the KG
      phase, CFKG and NFM none; an eval NGCF K7 6, K5 3, KG K8 1, K7 4,
      K5 3); then 2 warm-up and 8 timed steps, a KG epoch (KGAT/KGCN) and
      an eval with the counts read over them, step ms, epoch s, eval ms
      and the card's busy share over 8 profiled steps.
   g. walk_phase, the walk models on the flagship HIN at the CLI's walk
      defaults (emb 64, walk length 100, context 7, 1,000 walks a node, 5
      negatives, 8 starts a batch): one batch's positive walks on the card
      bitwise the CPU's from the same uniforms for both ML HeRec metapaths
      from the users and, on the CLI's `synthetic-yelp` HIN, the HeRec
      metapath 0 from the users (past its first relation's 6 rows: the
      walker's clamp, no device assert) and MetaPath2Vec's from
      item_reviewcount; one pretraining batch's skip-gram loss and
      embedding gradient against a CPU copy (1e-5), with its peak memory;
      a pretraining pass per HeRec metapath (75 batches, no repo kernel
      launched), ms a batch, peak memory, 5 timed and 3 profiled batches
      (busy share); one stage-2 step of MetaPath2VecTrainer and
      HeRecTrainer on those embeddings against a CPU copy (loss and every
      gradient 1e-5), a step's and an eval's launches (none).
   h. import_phase: a synthetic reference PEAGAT checkpoint at the
      flagship's shapes (pea_init(7)'s weights in the reference's naming)
      imported on the card (utils/torch_import), bitwise; the flagship
      trainer's eval of it (K12 1, K3 2), its representation and pair
      scores against the CPU import's forward (1e-4).
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
10'. The Yelp regime (yelp_phases), tools/bench_yelp.py:38-64's
   configuration built by the port's builders: synthetic_yelp_raw (seed 0,
   60,000 users, 8,000 items), build_yelp_hin(num_core 10, rejection):
   64,568 nodes, 755,962 train interactions, 57,144 test users; 11
   two-step channels, 64 -> 64 -> 16, entity-aware, batch 1,024, 'random'
   negatives, Adam; one PEATrainer per transport. The build's host
   seconds and the HIN's md5 (hin_digest: train_pos and every edge_index
   array); the grouped forward's groups ([[1] x 11, [6, 5]]); phases 10a-d
   at its shapes (ml25m_describe: 4 streaming calls, (1, 64) on u2i and
   i2u, (6, 16) on i2u, (5, 16) on u2i, and 9 composed convs;
   ml25m_kernel_phase without the piece sweep; ml25m_edge_kernel_phase:
   45 K7, 27 K5, 9 K6 calls a step; ml25m_phase per transport: launches
   K9 4, K10 4, K11 4, K8 9, K7 45, K5 27, K6 9, the step against
   plain_on_card, 2 + 8 timed steps, one eval over every test user, its
   HR@10 and AUC reported, not held); then one f32 step through the
   trainer with attention dropout 0.1 (yelp_dropout_step): no K9-K11
   launch (stream_gat_reference on the card), the composed convs' kernels,
   a finite loss and finite gradients.
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
   e'. archive_cli_phase: `--dataset ml-latest-small --dataset_url
      file://...` to a grouplens-layout zip written from
      tests/torch_raw_files.py's generator, into a fresh raw dir: the
      three CSVs extracted, PEAGCN 1 run x 1 epoch on the card, a finite
      Overall line.
   f. cli_datasets_phase: the published Yelp recipe (`--dataset
      synthetic-yelp`, 3 runs x 20 epochs, batch 1,024) and ML-25M recipe
      (`--dataset synthetic-ml25m`, 5 runs x 30 epochs, batch 4,096,
      rejection candidates), 'random' negatives: launches against the
      hybrid plan's prediction, the overall HR@10 in HR_BANDS around the
      JAX CLI's CPU result (JAX_CPU), each Yelp run's best HR@10 in the
      band and each ML-25M run's at least its initial; `--dropout 0.1`, 1
      run x 5 epochs per transport (a step's launches the per-channel
      route's, an eval's the hybrid plan's; the train loss falls); `--opt
      sparseadam`, 1 run x 3 epochs (launches, the loss falls; one step's
      untouched rows of x stay bitwise as they were, their count printed).
   g. baselines_cli_phase: `--model M --dataset synthetic-ml --runs 5
      --epochs 10` (the published recipe cut to 10 of its 30 epochs) for
      NGCF, KGAT, KGCN, CFKG and NFM, and KGAT with `--message_dtype bf16`: launches against the code's
      count, each run's best HR@10 above its initial, the overall HR@10
      within hr_band of the JAX CLI's CPU result (BASELINE_JAX_CPU); then
      an NFM run stopped after epoch 1 and resumed at epoch 2 by a second
      Solver, its BatchNorm buffers restored bitwise from `latest`.
   h. walk_cli_phase: `--model M --dataset synthetic-ml --runs 5 --epochs
      10` at the walk defaults for MetaPath2Vec and HeRec (no repo kernel
      launched; the overall HR@10 within hr_band of the JAX CLI's CPU
      result, WALK_JAX_CPU; a stage-1 file a run and metapath), one
      `synthetic-yelp` call of each (1 run x 5 epochs), then MetaPath2Vec
      `--runs 1` and `--runs 2` into one run directory (only seed 2021
      pretrained) and a new run directory over the same stage-1 cache
      (none pretrained).
12. Parallel phases (parallel_phase: parallel/, `--parallel edge`, `a2a`, `dp`),
   each world in processes of their own (run_ranks: a timeout each, every
   line printed with its rank, any rank's failure or timeout fails the
   run); phases a-c in one world of two ranks sharing cuda:0 over gloo,
   per transport:
   a. the flagship PEAGAT through ShardedPEATrainer: one step's launches
      per rank against the shard plan (K7 3, K5 2, K6 1 a union shard; no
      flash or batch-GAT kernel); its loss and all-reduced gradients the
      same on both ranks and, on rank 0, against the same code at a world
      of one (PAR_LOSS_TOL, PAR_LEAF_TOL, stream_excess) and the single-process
      PEATrainer's hybrid plan (mode_slice_phase's bars between routes);
      PAR_STEPS steps of train_step with bitwise-equal parameter digests
      on both ranks, step ms per rank and the all-reduces' ms (the last
      step with every collective timed, and the gradient buffer's
      all-reduce alone); then (rank 0) K7/K5/K6 at its union shards
      (replay_edge_calls) and an eval's launches (K12 in f32, K1 in bf16,
      twice: the union graphs, the hybrid plan off) with both calls timed
      (replay_flash_calls);
   b. the ML-25M regime's streaming route
      (make_stream_edge_sharded_train_step on each rank's shards of the
      per-channel graphs that the ML-25M phases built, pickled to the
      ranks): one step's K9/K10/K11 launches against the plan's channel
      groups; its loss and gradients against a world of one (phase a's
      bars) and the single-process grouped forward (the JAX
      test_stream_edge_sharded.py bars in f32); 2 steps, digests, step
      and all-reduce ms; K9-K11 at rank 0's shards in f32
      (ml25m_kernel_phase);
   c. KGAT through make_sharded_kg_trainer: a CF step's launches (K7 6,
      K5 3, K6 3) and loss (PAR_LOSS_TOL), one epoch's train_loss and
      kg_train_loss and the eval's HR@10 and AUC against the
      single-process KGTrainer (KG_EPOCH_BARS), digests equal; then which
      collectives gloo serves on CUDA tensors, the row-sharded route's
      all_to_all_single, all_gather_into_tensor and reduce_scatter_tensor
      held to their values (probe_collectives);
   f. `--parallel a2a` (the row-sharded table, all-to-all lookups) through
      ShardedPEATrainer: the flagship PEAGAT in f32 and bf16, PEAGCN and
      PEASage in f32: each rank's plan capacities, one step's launches
      against a2a_launches (PEAGAT K7 14, K6 12, K5 2; PEAGCN, PEASage
      K7 10, K6 8, K5 2), its collectives by name (calls, bytes,
      seconds), its loss and gradients (x's halves all-gathered) against
      the same code at a world of one (rank 0, the edge phases' bars); PEAGAT
      ROW_SHARDED_STEPS timed steps and K7/K5/K6 at one step's shapes
      (replay_edge_calls, rank 0); then in f32
   g. the a2a evaluator: an eval's launches (K7 10, K5 2), its
      99-negative ranks and the full-catalog sweep's against the
      single-process evaluators over the same cached rows, equal but for
      near ties (EVAL_TIE);
   h. `--parallel dp` at mp 2 (dp 1 x mp 2): per transport one flagship
      PEAGAT step's launches (K12/K1 2, K2 2), its loss and gradients (x's
      mp shards together) against a world of one, an eval (K12/K1 2, its
      metrics against the world of one's), and the step's K12/K1 and K2
      calls against their plain versions, timed (rank 0); then a step
      with attention dropout DROPOUT (the union graphs' composed route:
      K8 2, K7 10, K5 6, K6 2, no flash kernel), its loss and gradients
      against a world of one drawing the same masks (one generator
      seed), and its K8, K7, K5 and K6 calls against their plain
      versions, timed (rank 0);
   d. `python -m graph_recsys_benchmark_tpu_torch --parallel edge`, then
      `--parallel a2a` and `--parallel dp --mesh_mp 2` beside each other
      (CLI_MODES), each as two processes (--dist_* flags) against the
      same mode in one process: each epoch's train loss (1e-4) and HR@10
      (2/150); only rank 0 writes files; a resume of each by both ranks
      from rank 0's checkpoints;
   e. a world of one over NCCL (after NCCL asked for with two ranks on one
      card is refused, the layout named): phase a's world-of-one step
      against the gloo world's.
13. Prints the kernels' JSON line (a GAT forward's launches are the
   eval's, a GAT backward's the timed epoch's, an edge kernel's the last
   timed epoch of its path (at 300 columns 11d's CLI call: its epoch and
   the eval after it),
   K8-K11's and the ML-25M and Yelp entries of K5-K7 their regime's
   8 timed steps, the per-channel entries of K5-K8 one step of the mixed
   table, the baselines' entries of K5-K8 their model's timed run (9f), a
   variant route's forward its mode's eval and its
   backward its mode's 20 steps, the edge-parallel and row-sharded
   entries one step of rank 0 of 2, or one eval for K1/K12),
   then {"ok": true, "device": {...}} last.

Any failed check raises: the exit code is then nonzero and no result line
is printed.  Imports nothing of JAX.
"""

import contextlib
import copy
import dataclasses
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


def leaf_errors(label, params, ref, zero_floor=0.0):
    """Every gradient leaf of `params` against the same leaf of `ref` (a
    model of the same layout, on any device), relative to the ref leaf's
    largest value, sorted; every gradient present and finite, and exact
    zeros where ref's are (fc2's bias cancels in pos - neg).  With
    `zero_floor`, a ref leaf no larger than that share of the largest
    gradient of all is a zero but for rounding noise (NFM's fc1.b and
    bn0_bias, whose shifts the next BatchNorm removes): the leaf is held
    to the same share instead."""
    floor = zero_floor * max(float(r.grad.abs().max()) for r in ref.parameters())
    errs = []
    for (name, p), r in zip(params.named_parameters(), ref.parameters()):
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"{label} grad {name}: missing or not finite")
        if float(r.grad.abs().max()) > floor:
            errs.append((rel_err(p.grad.to(r.grad.device), r.grad)[1], name))
        else:
            check(float(p.grad.abs().max()) <= floor,
                  f"{label} grad {name}: expected {'exact zeros' if floor == 0 else 'noise'}")
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
    """Median device time of one fn() call by CUDA events
    (utils/profiling.device_ms)."""
    from graph_recsys_benchmark_tpu_torch.utils.profiling import device_ms as events_ms

    return events_ms(fn, reps, batches)


def bound_ms(nbytes, flops):
    """The least time of the work: its bytes over the H100's HBM rate or
    its f32 operations over its f32 peak (utils/roofline), the larger."""
    from graph_recsys_benchmark_tpu_torch.utils.roofline import (
        H100_F32_FLOPS,
        H100_HBM_BYTES_PER_S,
    )

    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    t_ops = flops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flagship_hin():
    """bench.py:42-59's synthetic ml-latest-small HIN (seed 7)."""
    from graph_recsys_benchmark_tpu_torch.data import build_mlsmall_hin, synthetic_mlsmall_raw

    movies, ratings, tagging = synthetic_mlsmall_raw(
        seed=7, num_users=600, num_items=900,
        min_ratings_per_user=40, max_ratings_per_user=200,
        num_directors=120, num_actors=320, num_writers=160,
        num_tags=180, tagging_rows=3000,
    )
    return build_mlsmall_hin(movies, ratings, tagging, num_core=10, num_feat_core=5)


def build_flagship():
    """The HIN and, per conv (gat, gcn, sage) and transport, a PEATrainer on
    the card with bench.py:42-59's configuration."""
    from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

    hin = flagship_hin()
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


def ml25m_describe(hin, trainer, label="ml25m", names=None, want=(4, 15)):
    """Print the grouped forward's step graphs and calls (ml25m_calls) of
    `trainer` and check their count against `want` (streaming calls,
    composed convs); names: the relations of each channel's steps."""
    names = ML25M_STEPS if names is None else names
    graphs = trainer.graphs
    stream, composed = ml25m_calls(graphs, (64, 16))
    seen = {}
    for c, ch in enumerate(graphs):
        for k, g in enumerate(ch):
            seen.setdefault(id(g), [g, names[c][k], []])[2].append((c, k + 1))

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
    print(f"{label}: {hin.num_nodes} nodes, {hin.train_pos.shape[0]} train interactions, "
          f"{hin.candidates.seen.shape[0]} test users (seen lists {hin.candidates.seen.shape}); "
          f"{len(seen)} distinct step graphs:\n  " + "\n  ".join(rows), flush=True)
    for k in range(2):
        print(f"{label} step {k + 1}: streaming calls "
              f"{[(len(ch), kz) for kk, _, ch, kz in stream if kk == k]} (channels "
              f"{[ch for kk, _, ch, _ in stream if kk == k]}); composed convs on channels "
              f"{[c for kk, _, c in composed if kk == k]}", flush=True)
    check((len(stream), len(composed)) == want,
          f"{label}: {len(stream)} streaming calls and {len(composed)} composed convs, "
          f"expected {want}")
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


def check_softmax(label, got, alpha, dst, n):
    """K8's output `got` against its plain version on the same inputs: the
    max bitwise, each row's sum within sum_bound of the float64 sum (each
    term exp(a - max) carrying the f32 subtraction's rounding, at most
    U_SUM of |a - max| as a factor exp of it, and expf's).  Returns (plain,
    float64 stats, the bound, the largest share of it taken)."""
    from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk

    plain = sk.softmax_stats_plain(alpha, dst, n)
    exact = sk.softmax_stats_plain(alpha.double(), dst, n)
    torch.cuda.synchronize()
    check(torch.equal(got[:, 0], plain[:, 0]), f"{label}: max differs")
    a64 = alpha.double()
    shift = torch.cat([torch.nan_to_num(exact[:, 0], neginf=0.0), a64.new_zeros(1)])
    d = a64 - shift[torch.clamp(dst.long(), max=n)]
    t = torch.exp(d)
    t_err = t * (torch.expm1(U_SUM * d.abs()) * (1 + EXPF_REL) + EXPF_REL)
    bound = sum_bound(t, dst, n, t_err)
    share = check_sum(label, got[:, 1], exact[:, 1], bound)
    return plain, exact, bound, share


def ml25m_kernel_phase(trainer, stream, composed, label="ml25m", sweep=True, reps=30,
                       plain_reps=5, transports=TDT):
    """K8 on every composed graph (weighted by its uses in one forward) and
    K9-K11 at the four streaming calls, per transport, against their plain
    versions on the card (atomic sums against float64 sums); with `sweep`
    K9-K11 also at pieces of STREAM_PIECES edges.  Lines of another label
    than ML-25M's start with it."""
    pre = "" if label == "ml25m" else f"{label} "
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
    for transport in transports:
        t_dtype = TDT[transport]
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
            plain, exact, bound, share = check_softmax(
                f"{pre}softmax_stats {transport} ({e} edges)", got, alpha, g.dst, n)
            err, rel = rel_err(got[:, 1].double(), exact[:, 1])
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
            print(f"{pre}softmax_stats {transport}: rows {n} edges {e} (padded {e_pad}) x{m} a "
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
                ms = device_ms(lambda: fn(*a, **kw), reps=reps)
                plain_ms = device_ms(lambda: plain(*a), reps=plain_reps)
                b_ms, b_by = bound_ms(nbytes, flops)
                print(f"{pre}{key} {transport}: n_ch {n_ch} kz {kz} rows {n} edges {e} (padded "
                      f"{g.dst.numel()}) rel_err vs float64 {rel:.3e} vs plain {rel_plain:.3e} "
                      f"ms {ms:.5f} plain_ms {plain_ms:.4f} bound_ms {b_ms:.5f} ({b_by}; "
                      f"{nbytes} bytes, {flops} flops)", flush=True)
                agg = aggs[key]
                agg["max_abs_err"] = max(agg["max_abs_err"], err)
                for k2, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                                ("nbytes", nbytes), ("flops", flops)):
                    agg[k2] += val
                if sweep:
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
        for key, pieces in sweeps.items():
            if sweep:
                print(f"{key} {transport}: (piece edges, ms of the 4 calls) "
                      f"{[(p, round(ms, 5)) for p, ms in pieces.items()]}; default "
                      f"{defaults[key]}", flush=True)
        torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def edge_calls_recorded():
    """{"gather": [(v, idx, n)], "segsum" / "scatter": [(rows, ids, n,
    order)]}: the arguments of every K7, K5 and K6 call (the wrappers'
    sk._gather and sk._sum_by_id) made inside the block."""
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

    sk._gather, sk._sum_by_id = rec_gather, rec_sum
    try:
        yield calls
    finally:
        sk._gather, sk._sum_by_id = gather, sum_by_id


def record_edge_calls(trainer):
    """edge_calls_recorded's record of one training step of `trainer` from
    init(2020), batch rows from a seeded generator."""
    bs = trainer.tcfg.batch_size
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = trainer.init(2020)
    opt = trainer.optimizer(params)
    rows = torch.randint(0, trainer.n_rows, (bs,), generator=gen, device="cuda")
    with edge_calls_recorded() as calls:
        trainer.train_step(params, opt, rows, torch.ones(bs, device="cuda"), gen)
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


def ml25m_edge_kernel_phase(trainers, label="ml25m"):
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
    results = {}
    for transport, trainer in trainers.items():
        results.update(replay_edge_calls(record_edge_calls(trainer), transport, label))
        torch.cuda.empty_cache()
    return results


def replay_edge_calls(calls, transport, label):
    """ml25m_edge_kernel_phase's checks and timings of one step's recorded
    K7, K5 and K6 calls (record_edge_calls) -> {(kind, transport): the
    kernels' JSON entry}."""
    from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk
    from graph_recsys_benchmark_tpu_torch.ops.segment import segment_sum

    results = {}
    gather, sum_by_id = sk._gather, sk._sum_by_id
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
                check(torch.equal(got, want), f"{label} gather {transport}: not a bitwise "
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
                          f"{label} {kind} {transport}: a walk that is not ids[perm]")
                got = sum_by_id(counter, *rec)
                exact = segment_sum(v.double(), ids, n)
                torch.cuda.synchronize()
                check_sum(f"{label} {kind} {transport} (rows {n}, width {v.shape[1]})", got,
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
        print(f"{label} {SEG_KERNELS[kind]} {transport}: {len(recs)} calls in one step "
              f"((rows, width, dtype, edges) x calls: "
              f"{sorted(shapes.items(), key=lambda kv: -kv[1])}); ms {ms:.5f} plain_ms "
              f"{plain_ms:.4f} library_ms {lib_ms:.5f} bound_ms {b_ms:.5f} ({b_by}; "
              f"{nbytes} bytes)", flush=True)
        for (width, dtype), (group, g_bytes, g_flops, run_sum, run_e) in sorted(
                groups.items(), key=lambda kv: -kv[1][1]):
            g_ms = device_ms(replay(group), reps=10)
            g_bound = bound_ms(g_bytes, g_flops)[0]
            line = (f"{label} {SEG_KERNELS[kind]} {transport} width {width} {dtype}: "
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


def ml25m_phase(trainer, stream, composed, label="ml25m"):
    """Per transport: one step's launches, one step's loss and gradients
    against the plain versions on the card, 2 warm-up and 8 timed steps
    (counts over them), a profiled step, one evaluation (launches, forward
    against the plain versions, wall, metrics)."""
    from graph_recsys_benchmark_tpu_torch.models.pea import pea_loss

    transport, cfg = trainer.transport, trainer.cfg
    label = f"{label} {transport}"
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


# the Yelp regime (tools/bench_yelp.py:38-64): the relations of each
# channel's steps (yelp_metapath_edges), for the printout
YELP_STEPS = (("u2i", "i2u"), ("i2u", "u2i"), ("st2i", "i2u"), ("rc2i", "i2u"),
              ("at2i", "i2u"), ("ca2i", "i2u"), ("ck2i", "i2u"), ("rc2u", "u2i"),
              ("fc2u", "u2i"), ("fa2u", "u2i"), ("st2u", "u2i"))
# the grouped forward's groups a step (channels sharing one graph), as the
# JAX package's own Yelp record reads them (BENCH_yelp.json "gates")
YELP_GROUPS = [[1] * 11, [6, 5]]
# GAT attention dropout of the dropout phases
DROPOUT = 0.1


def hin_digest(hin):
    """md5 of train_pos and of every edge_index array (name -> hex digest),
    and one md5 over all of them in that order."""
    import hashlib

    parts = {"train_pos": hin.train_pos}
    parts.update(hin.edge_index)
    out = {k: hashlib.md5(np.ascontiguousarray(v).tobytes()).hexdigest()
           for k, v in parts.items()}
    out["all"] = hashlib.md5("".join(out.values()).encode()).hexdigest()
    return out


def build_yelp():
    """tools/bench_yelp.py:38-64's configuration built by the port's code:
    synthetic_yelp_raw(seed 0, 60,000 users, 8,000 items, num_core 10, 80
    attributes, 60 categories), build_yelp_hin(num_core 10, rejection
    candidates), 11 two-step channels, 64 -> 64 -> 16, entity-aware, batch
    1,024, 'random' negatives, Adam; one PEATrainer per transport.  Host
    seconds printed, outside every timed window."""
    from graph_recsys_benchmark_tpu_torch.data import (
        build_yelp_hin, synthetic_yelp_raw, yelp_metapath_edges)
    from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

    t0 = time.perf_counter()
    raw = synthetic_yelp_raw(seed=0, num_users=60_000, num_items=8_000, num_core=10,
                             num_attributes=80, num_categories=60)
    t_raw = time.perf_counter() - t0
    t0 = time.perf_counter()
    hin = build_yelp_hin(*raw, num_core=10, candidate_mode="rejection")
    t_hin = time.perf_counter() - t0
    cfg = PEAConfig(conv="gat", num_nodes=hin.num_nodes, meta_path_steps=(2,) * 11,
                    emb_dim=64, hidden_size=64, repr_dim=16, entity_aware=True)
    tcfg = TrainConfig(batch_size=1024, sampling_strategy="random")
    edges = yelp_metapath_edges(hin)
    trainers, secs = {}, {}
    for t in TDT:
        t0 = time.perf_counter()
        trainers[t] = PEATrainer(hin, cfg, tcfg, edges, device="cuda", transport=t)
        torch.cuda.synchronize()
        secs[t] = time.perf_counter() - t0
    digest = hin_digest(hin)
    print(f"yelp build: raw frames {t_raw:.1f} s, HIN {t_hin:.1f} s host; trainer (graphs + "
          f"tables, to the card) {' / '.join(f'{secs[t]:.1f}' for t in TDT)} s host (f32 / "
          f"bf16); {hin.num_nodes} nodes ({hin.num_users} users, {hin.num_items} items); HIN "
          f"md5 {digest['all']} ({json.dumps(digest)})", flush=True)
    groups = []
    for k in range(2):
        shared = {}
        for ch in trainers["f32"].graphs:
            shared[id(ch[k])] = shared.get(id(ch[k]), 0) + 1
        groups.append(sorted(shared.values(), reverse=True))
    print(f"yelp grouped forward: channels sharing a graph, per step {groups}", flush=True)
    check(groups == YELP_GROUPS, f"yelp groups {groups}, expected {YELP_GROUPS}")
    return hin, trainers


def _per_channel_step(graphs):
    """A training step's launches on per-channel graphs under attention
    dropout: each composed conv its K8, K7 x5, K5 x3 and K6 (the ML-25M
    phase's counts a conv); a `gat_loops` conv runs stream_gat_reference
    (plain torch ops) and launches nothing."""
    n_c = sum(not g.gat_loops for ch in graphs for g in ch)
    return dict(softmax=n_c, gather=5 * n_c, segsum=3 * n_c, scatter=n_c)


def dropout_phase(hin, trainer):
    """PEAGAT f32 at the flagship with attention dropout DROPOUT: one
    training step's loss and every gradient on the card against a CPU copy
    under the same masks (drawn once on the CPU, DropoutMasks.to), through
    pea_loss with the trainer's hybrid plan, which hands the forward to its
    per-channel graphs: the launches of the per-channel route (no K1-K4),
    the loss and gradient rules of train_phase with kink_rows."""
    import dataclasses

    from graph_recsys_benchmark_tpu_torch.models.pea import DropoutMasks, pea_forward, pea_loss
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer

    cfg = dataclasses.replace(trainer.cfg, dropout=DROPOUT)
    bs = trainer.tcfg.batch_size
    cpu = PEATrainer(hin, cfg, trainer.tcfg, device="cpu")
    params = trainer.init(2020)
    with torch.no_grad():
        params.x.mul_(10.0)
        params.fc1["b"].mul_(0.1)
    cpu_params = copy.deepcopy(params).cpu()
    cgen = torch.Generator().manual_seed(3)
    batch = cpu._build_batch(torch.randperm(cpu.n_rows, generator=cgen)[:bs], cgen)
    masks = DropoutMasks(DROPOUT, torch.Generator().manual_seed(4))
    with torch.no_grad():
        pea_forward(cpu_params, cpu.graphs, cfg, masks=masks)  # draws every conv's masks
    card_masks = masks.to("cuda")
    kinks = kink_rows("dropout f32", batch,
                      (params, lambda m: pea_forward(m, trainer.graphs, cfg, masks=card_masks)),
                      (cpu_params, lambda m: pea_forward(m, cpu.graphs, cfg, masks=masks)))
    rmask = ((torch.arange(bs) < bs - 100) & ~kinks).float()
    reset_launches()
    loss = pea_loss(params, trainer.graphs, cfg, batch.cuda(), rmask.cuda(), masks=card_masks)
    loss.backward()
    torch.cuda.synchronize()
    launches = read_launches()
    cpu_loss = pea_loss(cpu_params, cpu.graphs, cfg, batch, rmask, masks=masks)
    cpu_loss.backward()
    want = expected(**_per_channel_step(trainer.graphs.per_channel))
    check(launches == want, f"dropout step: launches {launches}, expected {want}")
    tol = FORWARD_TOL["f32"]
    _, rel = rel_err(loss.detach().cpu(), cpu_loss.detach())
    check(rel <= tol, f"dropout step loss vs CPU: relative error {rel} > {tol}")
    errs = leaf_errors("dropout f32", params, cpu_params)
    median, worst = errs[len(errs) // 2], errs[-1]
    check(median[0] <= tol and worst[0] <= KINK_TOL,
          f"dropout grads vs CPU: median {median} > {tol} or worst {worst} > {KINK_TOL}")
    kept = torch.cat([m.flatten() for m in masks._drawn.values()]).float().mean()
    print(f"dropout {DROPOUT} f32 (flagship, the per-channel route): one step launches "
          f"{launches}; masks of {len(masks._drawn)} convs, kept share {float(kept):.4f}; loss "
          f"{float(loss.detach()):.6f} vs CPU {float(cpu_loss.detach()):.6f} (rel {rel:.3e}); "
          f"gradients vs CPU: median {median[1]} rel {median[0]:.3e}, worst {worst[1]} rel "
          f"{worst[0]:.3e}; {int(kinks.sum())} kink row(s) left out", flush=True)
    return launches


def yelp_dropout_step(trainer):
    """One Yelp-regime training step through the trainer with attention
    dropout DROPOUT (its cfg swapped for the step): the `gat_loops` convs
    run stream_gat_reference on the card, so no K9-K11 launch; the composed
    convs launch their kernels; the loss and every gradient finite."""
    import dataclasses

    cfg0 = trainer.cfg
    bs = trainer.tcfg.batch_size
    gen = torch.Generator(device="cuda").manual_seed(5)
    trainer.cfg = dataclasses.replace(cfg0, dropout=DROPOUT)
    try:
        params = trainer.init(2020)
        opt = trainer.optimizer(params)
        rows = torch.randint(0, trainer.n_rows, (bs,), generator=gen, device="cuda")
        reset_launches()
        t0 = time.perf_counter()
        loss = trainer.train_step(params, opt, rows, torch.ones(bs, device="cuda"), gen)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
    finally:
        trainer.cfg = cfg0
    want = expected(**_per_channel_step(trainer.graphs))
    check(launches == want, f"yelp dropout step: launches {launches}, expected {want}")
    check(bool(torch.isfinite(loss)), f"yelp dropout step: loss {float(loss)}")
    for name, p in params.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"yelp dropout step: grad {name} missing or not finite")
    print(f"yelp dropout {DROPOUT} {trainer.transport}: one step launches {launches} (no "
          f"K9-K11); loss {float(loss):.6f}; every gradient finite; step wall {secs * 1e3:.1f} "
          f"ms (the first, with stream_gat_reference's plain ops)", flush=True)
    return launches


def yelp_phases():
    """The Yelp regime (build_yelp), after the ML-25M phases: the build and
    the grouped forward's calls (4 streaming calls, 9 composed convs), K8
    and K9-K11 at the path's shapes (ml25m_kernel_phase, no piece sweep),
    K7, K5 and K6 replayed from one step (ml25m_edge_kernel_phase), per
    transport the step's launches, the step against plain_on_card, 2 + 8
    timed steps and one eval over every test user (ml25m_phase), then one
    step with attention dropout (yelp_dropout_step)."""
    hin, trainers = build_yelp()
    stream, composed = ml25m_describe(hin, trainers["f32"], "yelp", YELP_STEPS, (4, 9))
    kres = ml25m_kernel_phase(trainers["f32"], stream, composed, "yelp", sweep=False)
    eres = ml25m_edge_kernel_phase(trainers, "yelp")
    res = {t: ml25m_phase(trainers[t], stream, composed, "yelp") for t in TDT}
    for (kind, transport), r in eres.items():
        steps = res[transport]["launches"][kind] / 8
        check(r["calls"] == steps, f"yelp {kind} {transport}: {r['calls']} calls recorded "
              f"in one step, {steps} launches a timed step")
    drop = yelp_dropout_step(trainers["f32"])
    return kres, eres, res, drop


# the published Yelp and ML-25M recipes (JAX cli.py:165-212 and the dataset
# defaults: 3 runs x 20 epochs, batch 1,024 / 5 runs x 30 epochs, batch
# 4,096, 'random' negatives, f32, Adam) and the JAX CLI's results for them
# on a CPU (JAX_PLATFORMS=cpu; not a TPU's or the card's numbers, PERF.md
# section 2): (HR@10, NDCG@10, AUC)
YELP_RECIPE = ["--model", "PEAGAT", "--dataset", "synthetic-yelp", "--entity_aware", "true"]
ML25M_RECIPE = ["--model", "PEAGAT", "--dataset", "synthetic-ml25m", "--entity_aware", "true"]
JAX_CPU = {"synthetic-yelp": (0.1783, 0.1086, 0.4586),
           "synthetic-ml25m": (0.3173, 0.1719, 0.7423)}
# chip_smoke.py fails outside these bands of the overall HR@10: the JAX CPU
# result +- 4 standard errors of the difference of two independent R-run
# means of U-user hit rates, 4 * sqrt(2 * p (1 - p) / (U R)): Yelp p 0.1783,
# U 314, R 3 -> +-0.0706; ML-25M p 0.3173, U 150, R 5 -> +-0.0961
HR_BANDS = {"synthetic-yelp": (0.1077, 0.2489), "synthetic-ml25m": (0.2212, 0.4134)}
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


def cli_calls(tmp, extra=()):
    """(argv_of, trainer_of, run) over cli.main in the temporary directory
    `tmp`: argv_of(argv, out) -> the arguments with `extra`, the call's
    own --out_dir and one shared --cache_dir; trainer_of(argv, out) -> (the
    trainer and HIN that cli.main builds for these arguments); run(argv,
    out) -> (overall, launches, wall s, log path, log lines), every launch
    count set to 0 just before the call and read just after."""
    from graph_recsys_benchmark_tpu_torch import cli

    cache = os.path.join(tmp, "cache")

    def argv_of(argv, out):
        return list(argv) + list(extra) + ["--out_dir", os.path.join(tmp, out),
                                           "--cache_dir", cache]

    def trainer_of(argv, out):
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

    return argv_of, trainer_of, run


def recipe_call(trainer_of, run, label, argv, band, ref, per_run):
    """One published recipe through cli.main (cli_phase's `run`): its
    launches against the hybrid plan's prediction (a step's forward and
    backward launches x steps, plus a forward's x evals), each run's best
    HR@10 held by `per_run`: "above" its initial, "at_least" its initial,
    or in "band" (where an untrained scorer can beat the trained one: on
    synthetic-yelp the JAX CLI's own run 2 reads initial 0.3376, best
    0.1688), the overall HR@10 in `band`, printed beside `ref` (HR@10,
    NDCG@10 or None, AUC, its source).
    Returns (the trainer cli.main builds, a forward's launches, a
    backward's, steps an epoch, the call's numbers)."""
    trainer, hin = trainer_of(argv, label)
    check(trainer.device.type == "cuda", f"the CLI's trainer is on {trainer.device}")
    fwd, bwd = _plan_launches(trainer)
    runs, epochs, s = trainer.tcfg.runs, trainer.tcfg.epochs, trainer.num_batches
    overall, launches, wall, path, lines = run(argv, label)
    want = _predict(fwd, bwd, runs * epochs * s, runs * (epochs + 1))
    check(launches == want, f"{label} launches {launches}, predicted {want}")
    inits = [float(re.search(r"HR@10: ([0-9.]+)", ln).group(1)) for ln in lines
             if ln.startswith("Initial performance")]
    done = [re.search(r"Duration: ([0-9.]+)s, best HR@10: ([0-9.]+)", ln).groups()
            for ln in lines if ", Duration: " in ln]
    check(len(inits) == runs and len(done) == runs, f"{label} log {path}: {len(inits)} "
          f"initial and {len(done)} run lines for {runs} runs")
    bests = [float(b) for _, b in done]
    for r, (i, b) in enumerate(zip(inits, bests), start=1):
        ok = {"above": b > i, "at_least": b >= i, "band": band[0] <= b <= band[1]}[per_run]
        check(ok, f"{label} run {r}: best HR@10 {b}, initial {i}: not {per_run} "
              f"({'the band ' + str(band) if per_run == 'band' else 'its initial'})")
    hr10, ndcg10 = float(overall["HR"][5]), float(overall["NDCG"][5])
    auc = float(np.ravel(overall["AUC"])[0])
    check(band[0] <= hr10 <= band[1], f"{label} overall HR@10 {hr10} outside {band}")
    run_s = [float(d) for d, _ in done]
    r_hr, r_ndcg, r_auc, r_src = ref
    print(f"{label} ({hin.name}: {hin.num_nodes} nodes, {hin.num_users} test users, "
          f"{hin.train_pos.shape[0]} train interactions, {s} steps an epoch of "
          f"{trainer.tcfg.batch_size}, {trainer.tcfg.sampling_strategy} negatives, "
          f"{trainer.tables.mode} candidates; {runs} runs x {epochs} epochs): initial HR@10 "
          f"{inits} best HR@10 {bests} overall HR@10 {hr10:.4f} NDCG@10 {ndcg10:.4f} AUC "
          f"{auc:.4f} ({r_src}: HR@10 {r_hr}"
          + ("" if r_ndcg is None else f", NDCG@10 {r_ndcg}")
          + f", AUC {r_auc}; HR@10 {hr10 - r_hr:+.4f}, AUC {auc - r_auc:+.4f}; band {band}); "
          f"wall {wall:.2f} s, runs {run_s} s, {sum(run_s) / (runs * epochs):.4f} s an epoch; "
          f"launches {launches}", flush=True)
    return trainer, fwd, bwd, s, dict(hr10=hr10, ndcg10=ndcg10, auc=auc, wall=wall,
                                      launches=launches)


def _train_losses(lines):
    return [float(re.search(r"train loss: ([0-9.eE+-]+)", ln).group(1)) for ln in lines
            if ", epoch: " in ln and "exclude" not in ln]


def cli_datasets_phase(tmp):
    """The CLI choices this slice ports, through cli.main in process (each
    call with every launch count set to 0 just before and read just after):
    a. the published Yelp and ML-25M recipes (recipe_call, HR_BANDS; each
       Yelp run's best HR@10 in the band, each ML-25M run's at least its
       initial);
    b. --dropout 0.1 on the flagship recipe, 1 run x 5 epochs, per
       transport: a training step takes the per-channel route
       (_per_channel_step: no K1-K4), an eval the hybrid plan (1 flash
       forward, 2 batched forwards); launches against that prediction, the
       train loss falling over the epochs;
    c. --opt sparseadam, 1 run x 3 epochs: launches, the loss falling; then
       one step from init(0): the rows of x that it leaves untouched (a
       zero gradient row) stay bitwise as they were."""
    _, trainer_of, run = cli_calls(tmp)
    out = {}
    # a. the Yelp and ML-25M recipes
    for argv, per_run in ((YELP_RECIPE, "band"), (ML25M_RECIPE, "at_least")):
        ds = argv[3]
        r_hr, r_ndcg, r_auc = JAX_CPU[ds]
        *_, out[ds] = recipe_call(trainer_of, run, ds, argv, HR_BANDS[ds],
                                  (r_hr, r_ndcg, r_auc, "the JAX CLI on a CPU"), per_run)

    # b. attention dropout through the CLI
    out["dropout"] = {}
    for t in TDT:
        argv = RECIPE + ["--dropout", str(DROPOUT), "--runs", "1", "--epochs", "5",
                         "--message_dtype", t]
        tr, _ = trainer_of(argv, f"dropout-{t}")
        fwd, _ = _plan_launches(tr)
        steps = 5 * tr.num_batches
        want = {k: v * steps for k, v in _per_channel_step(tr.graphs.per_channel).items()}
        want.update({k: v * 6 for k, v in fwd.items()})  # the init eval and 5 epochs' evals
        want = expected(**want)
        overall, launches, wall, _, lines = run(argv, f"dropout-{t}")
        check(launches == want, f"dropout {t}: launches {launches}, predicted {want}")
        losses = _train_losses(lines)
        check(len(losses) == 5 and losses[-1] < losses[0], f"dropout {t}: losses {losses}")
        print(f"dropout {DROPOUT} {t} (1 run x 5 epochs, {steps} steps): train loss {losses}; "
              f"HR@10 {float(overall['HR'][5]):.4f}; wall {wall:.2f} s; launches {launches} "
              f"(K1-K4 only the 6 evals' forwards)", flush=True)
        out["dropout"][t] = launches

    # c. SparseAdam through the CLI, then its untouched rows
    argv = RECIPE + ["--opt", "sparseadam", "--runs", "1", "--epochs", "3"]
    tr, hin = trainer_of(argv, "sparseadam")
    fwd, bwd = _plan_launches(tr)
    overall, launches, wall, _, lines = run(argv, "sparseadam")
    want = _predict(fwd, bwd, 3 * tr.num_batches, 4)
    check(launches == want, f"sparseadam: launches {launches}, predicted {want}")
    losses = _train_losses(lines)
    check(len(losses) == 3 and losses[-1] < losses[0], f"sparseadam: losses {losses}")
    params = tr.init(0)
    opt = tr.optimizer(params)
    check(type(opt).__name__ == "SparseAdam", f"--opt sparseadam built {type(opt).__name__}")
    before = params.x.detach().clone()
    bs = tr.tcfg.batch_size
    gen = torch.Generator(device="cuda").manual_seed(0)
    tr.train_step(params, opt, torch.arange(bs, device="cuda"), torch.ones(bs, device="cuda"),
                  gen)
    untouched = ~(params.x.grad != 0).any(dim=1)
    n_real = int(untouched[:hin.num_nodes].sum())
    check(torch.equal(params.x.detach()[untouched], before[untouched]),
          "sparseadam: an untouched row of x moved")
    check(not torch.equal(params.x.detach()[~untouched], before[~untouched]),
          "sparseadam: no touched row of x moved")
    print(f"sparseadam (1 run x 3 epochs): train loss {losses}; HR@10 "
          f"{float(overall['HR'][5]):.4f}; wall {wall:.2f} s; launches {launches}; one step "
          f"leaves {n_real} of the {hin.num_nodes} node rows of x untouched (and the "
          f"{params.x.shape[0] - hin.num_nodes} padding rows), each bitwise as it was",
          flush=True)
    out["sparseadam"] = launches
    return out


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
    from graph_recsys_benchmark_tpu_torch.eval.full_ranking import evaluate_full_ranking
    from graph_recsys_benchmark_tpu_torch.models.pea import pea_predict
    from graph_recsys_benchmark_tpu_torch.train.sampling import build_device_tables
    from graph_recsys_benchmark_tpu_torch.utils.checkpoint import load_checkpoint

    argv_of, trainer_of, run = cli_calls(tmp, recipe_extra)

    out = {}
    # a. the recipe
    trainer, fwd, bwd, s, out["recipe"] = recipe_call(
        trainer_of, run, "recipe", RECIPE, HR_BAND,
        (JAX_HR10, None, JAX_AUC, f"JAX {JAX_RECIPE}"), per_run="above")

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


# ---------------------------------------------------------------- the
# per-channel forwards (mixed metapath depths, fused=False), the profiling
# and roofline utilities, a local dataset archive

MIXED_STEPS = (1,) + (2,) * 8
# (conv, table): 'mixed' = MIXED_STEPS with channel 0 cut to its first
# step; 'unfused' = the uniform table with PEAConfig(fused=False)
PER_CHANNEL = (("gcn", "mixed"), ("sage", "mixed"), ("gat", "mixed"), ("gcn", "unfused"),
               ("sage", "unfused"))
# the per-channel bars of the CPU tests (tests/torch_per_channel_world.py):
# the loss, and the median gradient leaf (GAT in bf16: half a bf16 ulp,
# tests/test_torch_per_channel_grouped.py); every leaf at KINK_TOL
PC_TOL = {"f32": 1e-5, "bf16": 1e-3}
PC_MEDIAN = {("f32", False): 1e-5, ("bf16", False): 1e-3, ("f32", True): 1e-5,
             ("bf16", True): 2e-3}
# the port's CUDA kernels by symbol (csrc/*.cu), as a trace names them
PORT_KERNELS = ("gat_fwd_walk_kernel", "gat_bwd_walk_kernel", "gat_bwd_glue_walk_kernel",
                "gat_rowmax_walk_kernel", "gat_rowmax_decode_kernel", "row_gather_kernel",
                "scatter_add_kernel", "softmax_block_kernel", "stream_gat_fwd_kernel",
                "stream_gat_bwd_dst_kernel", "stream_gat_bwd_src_kernel")


def per_channel_launches(cfg, graphs, step=True):
    """The launches of one training step (step) or one eval forward on
    per-channel graphs (no `gat_loops` graph), from the code: a GCN or
    SAGE conv (nn/conv.propagate) gathers its source rows (K7) and sums the
    messages by dst (K5), backward the gather's K6 and the sum's K7; a
    composed GAT conv (nn/conv.gat_apply) of H heads gathers [h | a_src]
    and a_dst (K7 2), per head the softmax's K8 and its stats' gather (K7),
    and sums the messages (K5); backward the sum's K7, per head the
    softmax's K5 and K7, a_dst's K5 and the source rows' K6."""
    from graph_recsys_benchmark_tpu_torch.models.pea import _channel_layer_dims

    counts = {}
    for ch in graphs:
        for (_, _, heads), g in zip(_channel_layer_dims(cfg, len(ch)), ch):
            check(not g.gat_loops, "per_channel_launches: a gat_loops graph")
            if cfg.conv == "gat":
                parts = [dict(gather=2 + heads, softmax=heads, segsum=1),
                         dict(gather=1 + heads, segsum=1 + heads, scatter=1)]
            else:
                parts = [dict(gather=1, segsum=1), dict(gather=1, scatter=1)]
            for part in parts if step else parts[:1]:
                for k, v in part.items():
                    counts[k] = counts.get(k, 0) + v
    return counts


def _cpu_graphs(graphs):
    """A trainer's graphs on the CPU: a HybridGATPlan, union graphs or
    per-channel graphs."""
    from graph_recsys_benchmark_tpu_torch.graph import StepGraph, graphs_to

    if hasattr(graphs, "per_channel"):
        return graphs.to("cpu")
    if isinstance(graphs[0], StepGraph):
        return tuple(g.to("cpu") for g in graphs)
    return graphs_to(graphs, "cpu")


def step_vs_references(trainer, label, cpu=True):
    """One step's loss and every gradient on the card against the same
    step with every kernel's plain version on the card (plain_on_card) and,
    with `cpu`, on a CPU copy: weights off the init regime, a seeded batch,
    a partial row mask without the kink_rows of the card and the CPU (or
    the plain run); the loss within PC_TOL, the median leaf within
    PC_MEDIAN, every leaf within KINK_TOL."""
    from graph_recsys_benchmark_tpu_torch.models.pea import pea_forward, pea_loss

    cfg, transport, bs = trainer.cfg, trainer.transport, trainer.tcfg.batch_size
    params = trainer.init(2020)
    with torch.no_grad():
        params.x.mul_(10.0)
        params.fc1["b"].mul_(0.1)
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = trainer._build_batch(torch.randperm(trainer.n_rows, device="cuda",
                                                generator=gen)[:bs], gen)
    refs = [("plain on the card", copy.deepcopy(params), trainer.graphs, "cuda")]
    if cpu:
        refs.append(("CPU", copy.deepcopy(params).cpu(), _cpu_graphs(trainer.graphs), "cpu"))

    def ref_forward(graphs):
        return lambda m: pea_forward(m, graphs, cfg, transport=transport,
                                     flash_mode=trainer.flash_mode)

    if cpu:
        kinks = kink_rows(label, batch, (params, trainer.eval_forward),
                          (refs[1][1], ref_forward(refs[1][2])))
    else:
        def plain_forward(m):
            with plain_on_card():
                return ref_forward(trainer.graphs)(m)

        kinks = kink_rows(label, batch, (params, trainer.eval_forward),
                          (refs[0][1], plain_forward))
    rmask = ((torch.arange(bs) < bs - 100) & ~kinks).float()
    loss = trainer.batch_loss(params, batch, rmask.cuda())
    loss.backward()
    tol, median_tol = PC_TOL[transport], PC_MEDIAN[(transport, cfg.conv == "gat")]
    line = []
    for name, ref_params, graphs, dev in refs:
        with plain_on_card() if dev == "cuda" else contextlib.nullcontext():
            ref_loss = pea_loss(ref_params, graphs, cfg, batch.to(dev), row_mask=rmask.to(dev),
                                transport=transport, flash_mode=trainer.flash_mode)
            ref_loss.backward()
        torch.cuda.synchronize()
        _, rel = rel_err(loss.detach().cpu(), ref_loss.detach().cpu())
        check(rel <= tol, f"{label} step loss vs {name}: relative error {rel} > {tol}")
        errs = leaf_errors(label, params, ref_params)
        median, worst = errs[len(errs) // 2], errs[-1]
        check(median[0] <= median_tol and worst[0] <= KINK_TOL,
              f"{label} grads vs {name}: median {median} > {median_tol} or worst {worst} > "
              f"{KINK_TOL}")
        line.append(f"vs {name}: loss rel {rel:.3e}, gradients median {median[1]} "
                    f"{median[0]:.3e}, worst {worst[1]} {worst[0]:.3e}")
    print(f"{label}: one step ({int(kinks.sum())} kink row(s) left out) " + "; ".join(line),
          flush=True)


@contextlib.contextmanager
def softmax_calls_recorded():
    """[(alpha, dst, n, block_bounds)]: the arguments of every K8 call
    (sk.softmax_stats, its launches still counted) made inside the block,
    alpha copied."""
    from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk

    real = sk.softmax_stats
    calls = []

    def rec(alpha, dst, n, block_bounds=None):
        calls.append((alpha.detach().clone(), dst, n, block_bounds))
        return real(alpha, dst, n, block_bounds)

    rec.launches = real.launches
    sk.softmax_stats = rec
    try:
        yield calls
    finally:
        sk.softmax_stats = real
        real.launches = rec.launches


def softmax_calls_phase(trainer, label):
    """K8 at the shapes one training step gives it: the step's
    softmax_stats calls recorded, then replay_softmax_calls."""
    bs = trainer.tcfg.batch_size
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = trainer.init(2020)
    opt = trainer.optimizer(params)
    rows = torch.randint(0, trainer.n_rows, (bs,), generator=gen, device="cuda")
    with softmax_calls_recorded() as calls:
        trainer.train_step(params, opt, rows, torch.ones(bs, device="cuda"), gen)
    return replay_softmax_calls(calls, label)


def replay_softmax_calls(calls, label):
    """Each recorded K8 call (softmax_calls_recorded) against its plain
    version (check_softmax), then all of them timed back to back beside
    the plain versions, the library composition (scatter_reduce_ amax +
    index_add_ of the exps) and the bound (every logit and id read once,
    the [N, 2] table written once; 4 operations a real edge) -> the
    kernels' JSON entry of the calls' sums."""
    from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk

    real = sk.softmax_stats
    nbytes = flops = 0
    worst = 0.0
    for alpha, dst, n, bb in calls:
        got = real(alpha, dst, n, bb)
        _, exact, _, _ = check_softmax(f"{label} softmax_stats ({dst.numel()} edges)", got,
                                       alpha, dst, n)
        worst = max(worst, rel_err(got[:, 1].double(), exact[:, 1])[0])
        nbytes += 8 * dst.numel() + 8 * n
        flops += 4 * int((dst < n).sum())

    def kernel():
        for a, d, n, bb in calls:
            real(a, d, n, bb)

    def plain():
        for a, d, n, _ in calls:
            sk.softmax_stats_plain(a, d, n)

    ids = [torch.clamp(d.long(), max=n) for _, d, n, _ in calls]

    def lib():
        for (a, _, n, _), d64 in zip(calls, ids):
            mx = torch.full((n + 1,), float("-inf"), device="cuda").scatter_reduce_(
                0, d64, a, "amax")
            torch.zeros(n + 1, device="cuda").index_add_(0, d64, torch.exp(a - mx[d64]))

    ms, plain_ms, lib_ms = device_ms(kernel, reps=10), device_ms(plain, reps=3), device_ms(
        lib, reps=10)
    b_ms, b_by = bound_ms(nbytes, flops)
    print(f"{label} softmax_stats: {len(calls)} calls in one step (rows, edges) "
          f"{sorted({(n, d.numel()) for _, d, n, _ in calls})}; ms {ms:.5f} plain_ms "
          f"{plain_ms:.4f} library_ms {lib_ms:.5f} bound_ms {b_ms:.5f} ({b_by})", flush=True)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, calls=len(calls))


def per_channel_phase(hin):
    """The per-channel forwards at the flagship's full width (64 -> 64 ->
    16, 9 channels, batch 1,024, entity-aware), per transport: PEAGCN,
    PEASage and PEAGAT on the mixed table (channel 0 its first step only),
    PEAGCN and PEASage with fused=False on the uniform table.  Each: an
    eval forward's and a step's launches against per_channel_launches, two
    steps on one batch (the loss falls), one step against the plain
    versions on the card and a CPU copy (step_vs_references); on the mixed
    table every K7, K5 and K6 call of a step (ml25m_edge_kernel_phase) and
    every K8 call (softmax_calls_phase) against its plain version, timed.
    Then the card checks of ROADMAP Queue 3, PEAGAT per transport, one step
    each against plain_on_card with its launches: num_heads 2 on the
    hybrid plan and on the mixed table, channel_aggr 'mean' and 'concat' on
    the hybrid plan."""
    from graph_recsys_benchmark_tpu_torch.data import mlsmall_metapath_edges
    from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

    edges = list(mlsmall_metapath_edges(hin))
    tables = {"mixed": (MIXED_STEPS, [edges[0][:1]] + edges[1:]), "unfused": ((2,) * 9, edges)}

    def make(conv, table, transport, **kw):
        steps, mp = tables[table]
        cfg = PEAConfig(conv=conv, num_nodes=hin.num_nodes, meta_path_steps=steps, emb_dim=64,
                        hidden_size=64, repr_dim=16, entity_aware=True,
                        fused=table == "mixed", **kw)
        return PEATrainer(hin, cfg, TrainConfig(), metapath_edges=mp, device="cuda",
                          transport=transport)

    kernels, launches = {}, {}
    for conv, table in PER_CHANNEL:
        for transport in TDT:
            t0 = time.perf_counter()
            trainer = make(conv, table, transport)
            label = f"per-channel {conv} {table} {transport}"
            graphs, cfg, bs = trainer.graphs, trainer.cfg, trainer.tcfg.batch_size
            check(isinstance(graphs[0], tuple) and [len(ch) for ch in graphs] ==
                  list(cfg.meta_path_steps), f"{label}: not the per-channel graphs")
            params = trainer.init(2020)
            reset_launches()
            with torch.no_grad():
                rep = trainer.eval_forward(params)
            torch.cuda.synchronize()
            eval_launches, want = read_launches(), expected(**per_channel_launches(cfg, graphs,
                                                                                   False))
            check(eval_launches == want, f"{label} eval: launches {eval_launches}, want {want}")
            check(rep.shape == (cfg.num_nodes, cfg.repr_dim) and bool(torch.isfinite(rep).all()),
                  f"{label}: repr {tuple(rep.shape)} or not finite")
            opt = trainer.optimizer(params)
            rows = torch.randint(0, trainer.n_rows, (bs,), device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(2))
            mask = torch.ones(bs, device="cuda")
            reset_launches()
            first = trainer.train_step(params, opt, rows, mask,
                                       torch.Generator(device="cuda").manual_seed(5))
            torch.cuda.synchronize()
            step_launches, want = read_launches(), expected(**per_channel_launches(cfg, graphs))
            check(step_launches == want, f"{label} step: launches {step_launches}, want {want}")
            second = trainer.train_step(params, opt, rows, mask,
                                        torch.Generator(device="cuda").manual_seed(5))
            check(np.isfinite(float(first)) and float(second) < float(first),
                  f"{label}: the loss on one batch went {float(first)} -> {float(second)}")
            gen = torch.Generator(device="cuda").manual_seed(6)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(5):
                trainer.train_step(params, opt, rows, mask, gen)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t1) / 5 * 1e3
            print(f"{label}: {sum(len(ch) for ch in graphs)} convs, "
                  f"{len({id(g) for ch in graphs for g in ch})} distinct graphs; eval "
                  f"launches {eval_launches}; step launches {step_launches}; the loss on one "
                  f"batch {float(first):.6f} -> {float(second):.6f}; step ms {step_ms:.4f} "
                  "(5 steps after 2)", flush=True)
            step_vs_references(trainer, label)
            if table == "mixed":
                for (kind, t), r in ml25m_edge_kernel_phase({transport: trainer},
                                                            label=label).items():
                    check(r["calls"] == step_launches[kind],
                          f"{label} {kind}: {r['calls']} calls recorded, "
                          f"{step_launches[kind]} launches a step")
                    kernels[(kind, conv, t)] = r
                if conv == "gat":
                    kernels[("softmax", conv, transport)] = softmax_calls_phase(trainer, label)
            launches[(conv, table, transport)] = step_launches
            print(f"{label}: {time.perf_counter() - t0:.1f} s", flush=True)
            del trainer, params, opt
            torch.cuda.empty_cache()

    # ROADMAP Queue 3's card checks
    checks = (("hybrid heads 2", "unfused", dict(num_heads=2, fused=True)),
              ("mixed heads 2", "mixed", dict(num_heads=2)),
              ("hybrid channel_aggr mean", "unfused", dict(channel_aggr="mean", fused=True)),
              ("hybrid channel_aggr concat", "unfused", dict(channel_aggr="concat", fused=True)))
    for name, table, kw in checks:
        for transport in TDT:
            steps, mp = tables[table]
            cfg = PEAConfig(conv="gat", num_nodes=hin.num_nodes, meta_path_steps=steps,
                            emb_dim=64, hidden_size=64, repr_dim=16, entity_aware=True, **kw)
            trainer = PEATrainer(hin, cfg, TrainConfig(), metapath_edges=mp, device="cuda",
                                 transport=transport)
            label = f"PEAGAT {name} {transport}"
            if hasattr(trainer.graphs, "per_channel"):
                heads = cfg.num_heads
                want = expected(flash_fwd=heads, batch_fwd=2, flash_bwd=heads, batch_bwd=2)
            else:
                want = expected(**per_channel_launches(cfg, trainer.graphs))
            params = trainer.init(2020)
            opt = trainer.optimizer(params)
            bs = trainer.tcfg.batch_size
            reset_launches()
            loss = trainer.train_step(params, opt, torch.arange(bs, device="cuda"),
                                      torch.ones(bs, device="cuda"),
                                      torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
            got = read_launches()
            check(got == want and np.isfinite(float(loss)),
                  f"{label}: launches {got}, want {want}; loss {float(loss)}")
            print(f"{label}: step launches {got}", flush=True)
            step_vs_references(trainer, label, cpu=False)
            del trainer, params, opt
            torch.cuda.empty_cache()
    return dict(kernels=kernels, launches=launches)


def profiling_phase(trainers, smi):
    """utils/profiling and utils/roofline on one flagship PEAGAT training
    step, per transport: in f32 a trace (profiling.trace, a StepTimer range
    around the step) that must list the port's kernels by name; then the
    step's cost counted (roofline.count_cost: aten ops plus the kernel
    wrappers' declared terms), its mean seconds (profiling.timed, 20 steps
    after 3) and its roofline_report, hbm_util and mfu each in (0, 1]
    beside the card's name and power limit."""
    from graph_recsys_benchmark_tpu_torch.utils import profiling, roofline

    out = {}
    for transport, trainer in trainers.items():
        params = trainer.init(2020)
        opt = trainer.optimizer(params)
        bs = trainer.tcfg.batch_size
        rows, mask = torch.arange(bs, device="cuda"), torch.ones(bs, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)

        def step():
            return trainer.train_step(params, opt, rows, mask, gen)

        step()
        if transport == "f32":
            with tempfile.TemporaryDirectory() as d:
                with profiling.trace(d) as prof:
                    with profiling.StepTimer("pea_step") as timer:
                        timer.block_on(step())
                (name,) = os.listdir(d)
                with open(os.path.join(d, name)) as f:
                    events = json.load(f)["traceEvents"]
            names = {e.get("name", "") for e in events}
            found = sorted({k for k in PORT_KERNELS for n in names if k in n})
            check("pea_step" in names, "trace: no pea_step range")
            for k in ("gat_fwd_walk_kernel", "gat_bwd_walk_kernel"):
                check(k in found, f"trace: the flagship step's {k} not listed ({found})")
            device_us = sum(getattr(e, "self_device_time_total", 0.0)
                            for e in prof.key_averages()
                            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                            and not getattr(e, "is_user_annotation", False))
            print(f"trace of one flagship PEAGAT f32 step: {name}, {len(events)} events, the "
                  f"port's kernels listed {found}; step {timer.elapsed * 1e3:.4f} ms (StepTimer), "
                  f"device time {device_us / 1e3:.4f} ms", flush=True)
        count = roofline.count_cost(step)
        secs = profiling.timed(step, iters=20, warmup=3)
        rep = roofline.roofline_report((count.flops, count.bytes), secs)
        check(0 < rep["hbm_util"] <= 1 and 0 < rep["mfu"] <= 1,
              f"roofline {transport}: hbm_util {rep['hbm_util']} or mfu {rep['mfu']} "
              "outside (0, 1]")
        declared = sorted(((v[1], k, v[2]) for k, v in count.by_name.items()
                           if not k.startswith("aten.")), reverse=True)
        aten = sorted(((v[1], k, v[2]) for k, v in count.by_name.items()
                       if k.startswith("aten.")), reverse=True)[:6]
        print(f"roofline flagship PEAGAT {transport} step ({smi}): {json.dumps(rep)}; step ms "
              f"{secs * 1e3:.4f} (timed, 20 after 3); declared (bytes, wrapper, calls) "
              f"{declared}; largest aten (bytes, op, calls) {aten}", flush=True)
        out[transport] = dict(rep, step_ms=secs * 1e3)
    return out


def archive_cli_phase(tmp):
    """The CLI with --dataset_url file:// to a grouplens-layout zip written
    from tests/torch_raw_files.py's generator, into a fresh raw dir: the
    archive extracted, PEAGCN 1 run x 1 epoch on the card at a small width,
    a finite Overall line."""
    from graph_recsys_benchmark_tpu_torch import cli

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_raw_files import write_ml_zip

    zpath = write_ml_zip(os.path.join(tmp, "ml-latest-small.zip"))
    raw = os.path.join(tempfile.mkdtemp(dir=tmp), "ml-latest-small")
    t0 = time.perf_counter()
    reset_launches()
    overall = cli.main(["--model", "PEAGCN", "--dataset", "ml-latest-small", "--raw_dir", raw,
                        "--dataset_url", "file://" + zpath, "--num_core", "2",
                        "--num_feat_core", "2", "--runs", "1", "--epochs", "1", "--emb_dim",
                        "16", "--hidden_size", "16", "--repr_dim", "8",
                        "--out_dir", os.path.join(tmp, "archive-runs"),
                        "--cache_dir", os.path.join(tmp, "archive-hin")])
    torch.cuda.synchronize()
    got = read_launches()
    files = sorted(os.listdir(raw))  # the archive's copy beside its files, as in JAX
    check({"movies.csv", "ratings.csv", "tags.csv"} <= set(files),
          f"archive: extracted {files}")
    check(bool(np.isfinite(overall["HR"]).all()) and got["gather"] > 0 and got["segsum"] > 0,
          f"archive: HR {overall['HR']}, launches {got}")
    print(f"cli --dataset_url file:// (ml-latest-small layout, 1 run x 1 epoch): raw dir "
          f"{files}; HR@10 {overall['HR'][5]:.4f}; launches {got}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------- baselines

BASELINES = (("NGCF", "f32"), ("NGCF", "bf16"), ("KGAT", "f32"), ("KGAT", "bf16"),
             ("KGCN", "f32"), ("KGCN", "bf16"), ("CFKG", "f32"), ("NFM", "f32"))
# the baselines' launches by the code (train/baseline_trainers.py): an NGCF
# conv gathers by src and by dst (K7 2) and sums (K5 1), its backward K7 1
# (the sum), K6 1 (the src gather), K5 1 (the dst gather); a KG conv gathers
# by src only; the attention snapshot is K8 and the K7 of its stats; the KG
# phase, CFKG and NFM launch none
BASELINE_STEP = {"NGCF": dict(gather=9, segsum=6, scatter=3),
                 "KGAT": dict(gather=6, segsum=3, scatter=3)}
BASELINE_STEP["KGCN"] = BASELINE_STEP["KGAT"]
BASELINE_ATT = dict(softmax=1, gather=1)
BASELINE_EVAL = {"NGCF": dict(gather=6, segsum=3),
                 "KGAT": dict(softmax=1, gather=4, segsum=3)}
BASELINE_EVAL["KGCN"] = BASELINE_EVAL["KGAT"]
# message widths of the three convs (emb 64 -> 64 -> 32 -> 16): the gathers
# and their backwards take the convs' inputs (64, 64, 32); NGCF sums its
# outputs (64, 32, 16), the KG convs their inputs (64, 64, 32)
BASELINE_WIDTHS = (64, 32)


def _times(counts, k):
    return {name: v * k for name, v in counts.items()}


def _add(*counts):
    out = {}
    for c in counts:
        for name, v in c.items():
            out[name] = out.get(name, 0) + v
    return out


def baseline_epoch_launches(model, trainer):
    """One epoch's launches: NGCF's steps; KGAT/KGCN's attention snapshot
    and CF steps (the KG phase launches none); none for CFKG and NFM."""
    if model == "NGCF":
        return _times(BASELINE_STEP[model], trainer.num_batches)
    if model in ("KGAT", "KGCN"):
        return _add(BASELINE_ATT, _times(BASELINE_STEP[model], trainer.num_batches))
    return {}


def build_baseline(hin, model, transport, device="cuda"):
    """A baseline trainer on `hin` at the CLI's published widths (emb 64,
    hidden 64; NFM's dropout 0.3) and TrainConfig's defaults (batch 1,024,
    4 'unseen' negatives, Adam lr 1e-3, L2 1e-3)."""
    from graph_recsys_benchmark_tpu_torch.models.cfkg import CFKGConfig
    from graph_recsys_benchmark_tpu_torch.models.kg import KGConfig
    from graph_recsys_benchmark_tpu_torch.models.nfm import NFMConfig
    from graph_recsys_benchmark_tpu_torch.models.ngcf import NGCFConfig
    from graph_recsys_benchmark_tpu_torch.train import baseline_trainers as B
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import TrainConfig

    tcfg = TrainConfig()
    if model == "NGCF":
        return B.NGCFTrainer(hin, NGCFConfig(hin.num_nodes, 64, 64), tcfg, device=device,
                             transport=transport)
    if model in ("KGAT", "KGCN"):
        cfg = KGConfig(model.lower(), hin.num_nodes, hin.num_edge_types, 64, 64)
        return B.KGTrainer(hin, cfg, tcfg, device=device, transport=transport)
    if model == "CFKG":
        cfg = CFKGConfig(hin.num_nodes, hin.num_edge_types, hin.edge_type_dict["user2item"], 64)
        return B.CFKGTrainer(hin, cfg, tcfg, device=device)
    return B.NFMTrainer(hin, NFMConfig(hin.num_users, hin.num_items, 64, 64), tcfg,
                        device=device)


def baseline_loss(trainer, params, batch, mask, att=None):
    """The loss (with NFM, and its new statistics) of one step of the
    family's main phase without dropout: KGAT/KGCN's CF loss under `att`
    (None: the snapshot of `params`)."""
    if hasattr(trainer, "att_snapshot"):
        if att is None:
            att = trainer.att_snapshot(params)
        return trainer._cf_loss(params, att, batch, mask, None)
    if hasattr(trainer, "batch_loss"):  # NGCF, NFM: the method, on this trainer's graph
        return trainer.batch_loss(params, batch, mask)
    return trainer._batch_loss(params, batch, mask, None)  # CFKG: no graph


def baseline_step_vs_references(model, trainer, label):
    """One step's loss and every gradient on the card against the same step
    with every kernel's plain version on the card (plain_on_card) and on a
    CPU copy (the trainer's graph moved to the CPU): init(2020), a seeded
    batch, the last 100 rows padding; the loss within PC_TOL, the median
    leaf within PC_MEDIAN, every leaf within KINK_TOL; NFM's new BatchNorm
    statistics within PC_TOL; KGAT/KGCN's attention map within 1e-5 of its
    largest value.  Leaves the loss does not reach get zero gradients
    (train/engine.fill_grads), as every step gives them; a leaf whose exact
    gradient is 0 is held to 1e-6 of the largest (leaf_errors' zero_floor)."""
    from graph_recsys_benchmark_tpu_torch.train.engine import fill_grads

    transport, bs = trainer.transport, trainer.tcfg.batch_size
    params = trainer.init(2020)
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = trainer._build_batch(torch.randperm(trainer.n_rows, device="cuda",
                                                generator=gen)[:bs], gen)
    rmask = (torch.arange(bs, device="cuda") < bs - 100).float()
    cpu = copy.copy(trainer)
    if hasattr(trainer, "graph"):
        cpu.graph = trainer.graph.to("cpu")
    refs = [("plain on the card", copy.deepcopy(params), trainer, "cuda"),
            ("CPU", copy.deepcopy(params).cpu(), cpu, "cpu")]
    kg = hasattr(trainer, "att_snapshot")
    att = trainer.att_snapshot(params) if kg else None
    out = baseline_loss(trainer, params, batch, rmask, att)
    loss, state = out if trainer.has_state else (out, None)
    loss.backward()
    fill_grads(params)
    tol, median_tol = PC_TOL[transport], PC_MEDIAN[(transport, False)]
    line = []
    for name, ref_params, ref_tr, dev in refs:
        with plain_on_card() if dev == "cuda" else contextlib.nullcontext():
            ref_att = ref_tr.att_snapshot(ref_params) if kg else None
            if kg:
                _, rel = rel_err(att.cpu(), ref_att.cpu())
                check(rel <= 1e-5, f"{label} attention map vs {name}: {rel}")
            ref_out = baseline_loss(ref_tr, ref_params, batch.to(dev), rmask.to(dev), ref_att)
            ref_loss, ref_state = ref_out if trainer.has_state else (ref_out, None)
            ref_loss.backward()
            fill_grads(ref_params)
        torch.cuda.synchronize()
        _, rel = rel_err(loss.detach().cpu(), ref_loss.detach().cpu())
        check(rel <= tol, f"{label} step loss vs {name}: relative error {rel} > {tol}")
        if state is not None:
            for k, v in state.items():
                _, srel = rel_err(v.cpu(), ref_state[k].cpu())
                check(srel <= tol, f"{label} {k} vs {name}: relative error {srel}")
        errs = leaf_errors(label, params, ref_params, zero_floor=1e-6)
        median, worst = errs[len(errs) // 2], errs[-1]
        check(median[0] <= median_tol and worst[0] <= KINK_TOL,
              f"{label} grads vs {name}: median {median} > {median_tol} or worst {worst} > "
              f"{KINK_TOL}")
        line.append(f"vs {name}: loss rel {rel:.3e}, gradients median {median[1]} "
                    f"{median[0]:.3e}, worst {worst[1]} {worst[0]:.3e}")
    print(f"{label}: one step, loss {float(loss.detach()):.6f}; " + "; ".join(line), flush=True)


def baseline_launch_checks(model, trainer, label):
    """The launches of one step of each phase and of one eval, each with
    every count set to 0 just before and read just after, against
    BASELINE_STEP / BASELINE_ATT / BASELINE_EVAL."""
    bs = trainer.tcfg.batch_size
    params = trainer.init(2020)
    opt = trainer.optimizer(params)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, mask = torch.arange(bs, device="cuda"), torch.ones(bs, device="cuda")

    def counted(fn, want, what):
        reset_launches()
        res = fn()
        torch.cuda.synchronize()
        got = read_launches()
        check(got == expected(**want), f"{label} {what}: launches {got}, expected {want}")
        return res

    if model in ("KGAT", "KGCN"):
        counted(lambda: trainer.kg_step(params, opt, rows, mask, gen), {}, "KG-phase step")
        att = counted(lambda: trainer.att_snapshot(params), BASELINE_ATT, "attention snapshot")
        batch = trainer._build_batch(rows, gen)
        counted(lambda: trainer._step(params, opt, lambda: trainer._cf_loss(
            params, att, batch, mask, gen)), BASELINE_STEP[model], "CF step")
    else:
        counted(lambda: trainer.train_step(params, opt, rows, mask, gen),
                BASELINE_STEP.get(model, {}), "step")
    counted(lambda: trainer.evaluate(params, gen), BASELINE_EVAL.get(model, {}), "eval")


def baseline_timed_run(model, trainer, label):
    """2 warm-up and 8 timed steps of the family's main phase (KGAT/KGCN:
    CF steps under one snapshot), one KG epoch (KGAT/KGCN) and one eval,
    from init(2020), every count set to 0 before and read after against
    the prediction; step ms, epoch s, eval ms, the loss finite, and the
    card's busy share over 8 profiled steps (device_breakdown).  Returns
    the launches."""
    bs = trainer.tcfg.batch_size
    params = trainer.init(2020)
    opt = trainer.optimizer(params)
    gen = torch.Generator(device="cuda").manual_seed(5)
    kg = model in ("KGAT", "KGCN")
    reset_launches()
    att = trainer.att_snapshot(params) if kg else None

    def step():
        rows = torch.randint(0, trainer.n_rows, (bs,), generator=gen, device="cuda")
        mask = torch.ones(bs, device="cuda")
        if kg:
            batch = trainer._build_batch(rows, gen)
            return trainer._step(params, opt, lambda: trainer._cf_loss(params, att, batch,
                                                                       mask, gen))
        return trainer.train_step(params, opt, rows, mask, gen)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(8)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 8 * 1e3
    check(all(bool(torch.isfinite(v)) for v in losses), f"{label}: step losses {losses}")
    epoch_s = None
    if kg:
        t0 = time.perf_counter()
        out = trainer.run_epoch(params, opt, gen)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        check(set(out) == {"train_loss", "kg_train_loss"} and all(
            np.isfinite(float(v)) for v in out.values()), f"{label} epoch: {out}")
    t0 = time.perf_counter()
    m = trainer.evaluate(params, gen)
    hr10 = float(m["HR"][5])
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    want = _add(_times(BASELINE_STEP.get(model, {}), 10), BASELINE_EVAL.get(model, {}))
    if kg:
        want = _add(want, BASELINE_ATT, baseline_epoch_launches(model, trainer))
    check(launches == expected(**want), f"{label} timed run: launches {launches}, "
          f"predicted {expected(**want)}")
    check(np.isfinite(hr10), f"{label}: HR@10 {hr10}")
    print(f"{label}: step ms {step_ms:.4f} ({bs} rows, train examples/s "
          f"{bs / step_ms * 1e3:.1f}); " + (f"one epoch ({trainer.kg_batches} KG + "
          f"{trainer.num_batches} CF steps) {epoch_s:.3f} s; " if kg else "")
          + f"eval ({trainer.tables.test_users.numel()} users) ms {eval_ms:.3f}, HR@10 "
          f"{hr10:.4f}; launches over 10 steps{', an epoch' if kg else ''} and an eval "
          f"{launches}", flush=True)
    device_breakdown(lambda: [step() for _ in range(8)], f"{label} 8 steps", 8 * step_ms)
    return launches


def baseline_kernel_phase(trainers):
    """K7, K5 and K6 at the NGCF and KG graphs' shapes (edge_cases: each
    against its plain version, K5 and K6 row by row within sum_bound, with
    the device, plain and library ms and the bound), per transport; K8 on
    the KG graph at KGAT's and KGCN's attention logits of init(2020)
    (check_softmax), with its device, plain and library ms and the bound
    (every logit and id read once, the [N, 2] table written once; 4
    operations a real edge)."""
    from graph_recsys_benchmark_tpu_torch.models.kg import att_logits
    from graph_recsys_benchmark_tpu_torch.ops import segment_kernels as sk

    rng = np.random.default_rng(4)
    eres = {}
    for conv, model in (("ngcf", "NGCF"), ("kg", "KGAT")):
        g = trainers[(model, "f32")].graph
        print(f"baselines {model} graph: {g.num_nodes} rows, {g.num_edges} edges (padded "
              f"{g.dst.numel()})", flush=True)
        for d in BASELINE_WIDTHS:
            edge_cases(g, d, f"{conv} D {d}", conv, rng, eres)
    kres = {}
    for model in ("KGAT", "KGCN"):
        tr = trainers[(model, "f32")]
        g, n = tr.graph, tr.graph.num_nodes
        alpha = att_logits(tr.init(2020), g, tr.cfg)

        def kernel():
            return sk.softmax_stats(alpha, g.dst, n, g.block_bounds)

        got = kernel()
        _, exact, _, share = check_softmax(f"{model} softmax_stats", got, alpha, g.dst, n)
        d64 = torch.clamp(g.dst.long(), max=n)

        def lib():
            mx = torch.full((n + 1,), float("-inf"), device="cuda").scatter_reduce_(
                0, d64, alpha, "amax")
            return torch.zeros(n + 1, device="cuda").index_add_(0, d64,
                                                                torch.exp(alpha - mx[d64]))

        ms = device_ms(kernel)
        plain_ms = device_ms(lambda: sk.softmax_stats_plain(alpha, g.dst, n), reps=10)
        lib_ms = device_ms(lib)
        b_ms, b_by = bound_ms(8 * g.dst.numel() + 8 * n, 4 * g.num_edges)
        err = rel_err(got[:, 1].double(), exact[:, 1])[0]
        print(f"softmax_stats f32: {model} attention map, rows {n} edges {g.num_edges} "
              f"(padded {g.dst.numel()}) sum err vs float64 {err:.3e} ({share:.3f} of the "
              f"rounding bound) ms {ms:.5f} plain_ms {plain_ms:.5f} library_ms {lib_ms:.5f} "
              f"bound_ms {b_ms:.5f} ({b_by})", flush=True)
        kres[model] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms)
    return eres, kres


def baselines_phase(hin):
    """The baselines (NGCF, KGAT, KGCN per transport; CFKG, NFM in f32) on
    the flagship HIN at the CLI's published widths: the kernels at their
    graphs' shapes (baseline_kernel_phase), then per model one step against
    plain_on_card and a CPU copy, the launches of each phase's step and of
    an eval, and a timed run.  Returns (edge kernel results, K8 results,
    each run's launches)."""
    t0 = time.perf_counter()
    trainers = {key: build_baseline(hin, *key) for key in BASELINES}
    print(f"baselines: {len(trainers)} trainers built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    eres, kres = baseline_kernel_phase(trainers)
    launches = {}
    for (model, transport), tr in trainers.items():
        label = f"{model} {transport}"
        check(tr.device.type == "cuda", f"{label}: trainer on {tr.device}")
        baseline_step_vs_references(model, tr, label)
        baseline_launch_checks(model, tr, label)
        launches[(model, transport)] = baseline_timed_run(model, tr, label)
    return eres, kres, launches


BASELINE_MODELS = ("NGCF", "KGAT", "KGCN", "CFKG", "NFM")
# the published recipe's settings but 10 of its 30 epochs (batch 1,024,
# 'unseen' negatives, f32, Adam), which keeps the five models' calls near a
# minute on the card
BASELINE_ARGV = ["--dataset", "synthetic-ml", "--runs", "5", "--epochs", "10"]
# the JAX CLI's results on a CPU (JAX_PLATFORMS=cpu; not a TPU's or the
# card's numbers, PERF.md section 2) for `--model M` + BASELINE_ARGV:
# (HR@10, NDCG@10, AUC)
BASELINE_JAX_CPU = {"NGCF": (0.2893, 0.1516, 0.7127), "KGAT": (0.2960, 0.1616, 0.7169),
                    "KGCN": (0.2867, 0.1589, 0.7345), "CFKG": (0.2640, 0.1324, 0.7116),
                    "NFM": (0.2693, 0.1402, 0.6823)}


def hr_band(p, users, runs, ref_runs=5):
    """The JAX CPU result p (a mean of ref_runs runs) +- 4 standard errors of
    the difference of two independent run means of U-user hit rates, 4
    sqrt(p (1 - p) / U (1 / R + 1 / ref_runs)): 4 sqrt(2 p (1 - p) / (U R))
    for R = ref_runs."""
    w = 4.0 * (p * (1.0 - p) / users * (1.0 / runs + 1.0 / ref_runs)) ** 0.5
    return (p - w, p + w)


class _Stop(Exception):
    """Stops a Solver's run where a crash would."""


def baselines_cli_phase(tmp):
    """The five baselines through cli.main in process (cli_calls, each call
    with every launch count set to 0 just before and read just after):
    `--model M` + BASELINE_ARGV (5 runs x 10 epochs), and KGAT once more
    with `--message_dtype bf16`: the launches against the prediction (an
    epoch's x 50 epochs, plus an eval's x 55 evals), each run's best HR@10
    above its initial, the overall HR@10 within hr_band of the JAX CLI's
    CPU result; then an NFM run that stops
    after epoch 1 of 2 and a second Solver that resumes it at epoch 2 from
    its `latest` checkpoint, the BatchNorm buffers restored bitwise."""
    from graph_recsys_benchmark_tpu_torch.models.nfm import STATE
    from graph_recsys_benchmark_tpu_torch.train.solver import Solver

    argv_of, trainer_of, run = cli_calls(tmp)
    out = {}
    for model, extra in [(m, []) for m in BASELINE_MODELS] + [("KGAT", ["--message_dtype",
                                                                        "bf16"])]:
        label = f"cli {model}" + (" bf16" if extra else "")
        argv = ["--model", model] + BASELINE_ARGV + extra
        tr, hin = trainer_of(argv, label)
        check(tr.device.type == "cuda", f"{label}: the CLI's trainer is on {tr.device}")
        runs, epochs = tr.tcfg.runs, tr.tcfg.epochs
        overall, launches, wall, path, lines = run(argv, label)
        want = expected(**_add(_times(baseline_epoch_launches(model, tr), runs * epochs),
                               _times(BASELINE_EVAL.get(model, {}), runs * (epochs + 1))))
        check(launches == want, f"{label}: launches {launches}, predicted {want}")
        inits = [float(re.search(r"HR@10: ([0-9.]+)", ln).group(1)) for ln in lines
                 if ln.startswith("Initial performance")]
        bests = [float(re.search(r"best HR@10: ([0-9.]+)", ln).group(1)) for ln in lines
                 if ", Duration: " in ln]
        check(len(inits) == len(bests) == runs and all(b > i for i, b in zip(inits, bests)),
              f"{label} {path}: initial {inits}, best {bests}")
        r_hr, r_ndcg, r_auc = BASELINE_JAX_CPU[model]
        band = hr_band(r_hr, hin.candidates.test_users.shape[0], runs)
        hr10, auc = float(overall["HR"][5]), float(np.ravel(overall["AUC"])[0])
        check(band[0] <= hr10 <= band[1], f"{label}: overall HR@10 {hr10} outside {band}")
        print(f"{label} ({runs} runs x {epochs} epochs, {tr.num_batches} steps an epoch"
              + (f" + {tr.kg_batches} KG steps" if hasattr(tr, "kg_batches") else "")
              + f"): initial HR@10 {inits} best {bests} overall HR@10 {hr10:.4f} NDCG@10 "
              f"{float(overall['NDCG'][5]):.4f} AUC {auc:.4f} (the JAX CLI on a CPU: HR@10 "
              f"{r_hr}, NDCG@10 {r_ndcg}, AUC {r_auc}; HR@10 {hr10 - r_hr:+.4f}; band "
              f"({band[0]:.4f}, {band[1]:.4f})); wall {wall:.2f} s; launches {launches}",
              flush=True)
        out[label] = dict(hr10=hr10, auc=auc, wall=wall, launches=launches)

    # NFM: a run stopped after epoch 1, resumed at epoch 2 from `latest`
    argv = ["--model", "NFM", "--dataset", "synthetic-ml", "--runs", "1", "--epochs", "2",
            "--save_every_epoch", "0"]
    tr, _ = trainer_of(argv, "nfm-resume")
    folder = os.path.join(tmp, "nfm-resume", "solver")
    real, seen = tr.run_epoch, []

    def stop_at_2(params, opt, gen):
        if len(seen) == 1:
            raise _Stop("stopped before epoch 2")
        seen.append(None)
        return real(params, opt, gen)

    tr.run_epoch = stop_at_2
    try:
        Solver(tr, folder, runs=1, epochs=2, save_every_epoch=0).run()
        check(False, "nfm-resume: the run was not stopped")
    except _Stop:
        pass
    saved = torch.load(os.path.join(folder, "run_1", "latest.ckpt"), map_location="cpu",
                       weights_only=True)
    check(saved["epoch"] == 1, f"nfm-resume: latest at epoch {saved['epoch']}")
    resumed = {}

    def first(params, opt, gen):
        resumed.setdefault("state", {k: getattr(params, k).detach().clone() for k in STATE})
        return real(params, opt, gen)

    tr.run_epoch = first
    Solver(tr, folder, runs=1, epochs=2, save_every_epoch=0).run()
    fresh = tr.init(2020)
    for k in STATE:
        check(torch.equal(resumed["state"][k].cpu(), saved["params"][k])
              and not torch.equal(getattr(fresh, k), resumed["state"][k]),
              f"nfm-resume: {k} not restored from the checkpoint")
    _, lines = _log_lines(folder)
    epochs_logged = [int(re.search(r"epoch: (\d+)", ln).group(1)) for ln in lines
                     if ", epoch: " in ln]
    check(epochs_logged == [1, 2], f"nfm-resume: epochs logged {epochs_logged}")
    print(f"nfm-resume: stopped after epoch 1, resumed at epoch 2 with the BatchNorm buffers "
          f"of the checkpoint ({', '.join(STATE)}), bitwise", flush=True)
    return out


# the walk models' CLI defaults (JAX cli.py:89-93, train/walk_trainers.py:43-44)
WALK_DEFAULTS = dict(embedding_dim=64, walk_length=100, context_size=7, walks_per_node=1000,
                     num_negative_samples=5)
WALK_TOL = 1e-5  # the CPU tests' bar (tests/test_torch_walk_models.py)


def walk_config(hin, start):
    """The CLI's walk config on `hin`, walks from the type `start`."""
    from graph_recsys_benchmark_tpu_torch.models.metapath2vec import MP2VConfig

    return MP2VConfig(**WALK_DEFAULTS, start_offset=hin.type_accs[start],
                      num_start=hin.num_nodes_dict[start], num_nodes=hin.num_nodes)


def synthetic_yelp_hin():
    """The CLI's `synthetic-yelp` HIN, built by cli.load_hin."""
    from graph_recsys_benchmark_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        args = cli.build_parser().parse_args(["--dataset", "synthetic-yelp", "--cache_dir", tmp])
        return cli.load_hin(args)[0]


def walks_vs_cpu(hin, steps, start, label):
    """One pretraining batch's positive walks (8 starts x 1,000 walks of 100
    steps) from the same uniforms, drawn on the card, walked on the card and
    on the CPU: bitwise.  The last start is the start type's last node, so
    a metapath whose first relation has fewer rows than the start type has
    nodes walks past its tables (the clamp of models/metapath2vec.py)."""
    from graph_recsys_benchmark_tpu_torch.models.metapath2vec import (
        metapath_from_hin,
        walk_from_uniforms,
    )
    from graph_recsys_benchmark_tpu_torch.train.walk_trainers import RW_BATCH

    cfg = walk_config(hin, start)
    gen = torch.Generator(device="cuda").manual_seed(1)
    starts = torch.randperm(cfg.num_start, generator=gen, device="cuda")[:RW_BATCH]
    starts[-1] = cfg.num_start - 1
    u = torch.rand((cfg.walk_length, starts.numel() * cfg.walks_per_node), generator=gen,
                   device="cuda")
    card_csr = metapath_from_hin(hin, steps, "cuda")
    card = walk_from_uniforms(starts, card_csr, cfg, u)
    cpu = walk_from_uniforms(starts.cpu(), metapath_from_hin(hin, steps, "cpu"), cfg, u.cpu())
    torch.cuda.synchronize()
    check(torch.equal(card.cpu(), cpu), f"{label}: walks on the card differ from the CPU's")
    rows = int(card_csr[0].deg.shape[0])
    past = int((starts >= rows).sum())
    print(f"walks {label}: {tuple(card.shape)} from {starts.numel()} starts, bitwise the "
          "CPU's; "
          f"{past} of the starts past the first relation's {rows} rows; "
          f"{int(card[:, 1].unique().numel())} distinct first steps", flush=True)
    return past


def walk_batch_vs_cpu(hin, steps, label):
    """One pretraining batch at the CLI defaults on the card: the skip-gram
    loss and the embedding's gradient against a float64 CPU copy on the
    same walks (WALK_TOL of the largest value), and the batch's peak
    memory.  A start node's row sums the terms of its 1,000 walks' windows
    and a genre's millions: the card's F.embedding backward adds them in
    parallel pieces, an f32 CPU copy one after another, and the two orders
    part by ~4e-5 of the largest row; each is held to the float64 sum."""
    from graph_recsys_benchmark_tpu_torch.models import metapath2vec as M
    from graph_recsys_benchmark_tpu_torch.train.walk_trainers import RW_BATCH

    cfg = walk_config(hin, "uid")
    csr = M.metapath_from_hin(hin, steps, "cuda")
    params = M.mp2v_init(torch.Generator().manual_seed(2020), cfg).cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    starts = torch.randperm(cfg.num_start, generator=gen, device="cuda")[:RW_BATCH]
    pos = M.sample_pos_walks(gen, starts, csr, cfg)
    neg = M.sample_neg_walks(gen, starts, csr, cfg)
    ref = copy.deepcopy(params).cpu().double()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss = M.mp2v_loss(params, pos, neg, cfg)
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    ref_loss = M.mp2v_loss(ref, pos.cpu(), neg.cpu(), cfg)
    ref_loss.backward()
    cpu_s = time.perf_counter() - t0
    _, lrel = rel_err(loss.detach().cpu().double(), ref_loss.detach())
    _, grel = rel_err(params.emb.grad.cpu().double(), ref.emb.grad)
    check(lrel <= WALK_TOL and grel <= WALK_TOL,
          f"{label} batch vs CPU: loss rel {lrel}, gradient rel {grel} > {WALK_TOL}")
    print(f"walk batch {label}: {pos.shape[0]} positive + {neg.shape[0]} negative walks, loss "
          f"{float(loss.detach()):.6f}, vs the float64 CPU copy loss rel {lrel:.3e} gradient "
          f"rel {grel:.3e}; peak "
          f"memory of the forward and backward {peak / 2**30:.3f} GiB; the CPU copy "
          f"{cpu_s:.1f} s", flush=True)


def walk_gather_bytes(cfg, n_pos):
    """The bytes of the skip-gram's gathered blocks in one batch: each of
    the context_size row blocks [walks, windows, D] f32 of the positive and
    negative walks, written once by the forward (the JAX package's
    reckoning: the backward scatters about as much again)."""
    windows = cfg.walk_length + 2 - cfg.context_size
    walks = n_pos * (1 + cfg.num_negative_samples)
    return cfg.context_size * walks * windows * cfg.embedding_dim * 4


def walk_timed_pass(hin, steps, label):
    """A pretraining pass (train/walk_trainers.pretrain_mp2v, seed 2020) at
    the CLI defaults on `hin`, every launch count set to 0 before and read
    after (the walk path launches no repo kernel); ms a batch, the peak
    memory; then 5 timed batches and 3 profiled ones (device_breakdown: the
    card's busy share).  Returns the frozen embedding."""
    from graph_recsys_benchmark_tpu_torch.models import metapath2vec as M
    from graph_recsys_benchmark_tpu_torch.train.optim import SparseAdam
    from graph_recsys_benchmark_tpu_torch.train.walk_trainers import RW_BATCH, RW_LR, pretrain_mp2v

    cfg = walk_config(hin, "uid")
    n_batches = -(-cfg.num_start // RW_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    emb, loss = pretrain_mp2v(hin, steps, cfg, 2020, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(launches == expected(), f"{label} pass: launches {launches}, expected none")
    check(np.isfinite(loss) and bool(torch.isfinite(emb).all()) and emb.device.type == "cuda",
          f"{label} pass: loss {loss}")

    csr = M.metapath_from_hin(hin, steps, "cuda")
    params = M.MP2V({"emb": emb.clone()})
    opt = SparseAdam(params.parameters(), lr=RW_LR)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def batch():
        starts = torch.randint(0, cfg.num_start, (RW_BATCH,), generator=gen, device="cuda")
        pos = M.sample_pos_walks(gen, starts, csr, cfg)
        neg = M.sample_neg_walks(gen, starts, csr, cfg)
        opt.zero_grad()
        out = M.mp2v_loss(params, pos, neg, cfg)
        out.backward()
        opt.step()
        return out.detach()

    batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [batch() for _ in range(5)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    check(all(bool(torch.isfinite(v)) for v in losses), f"{label}: batch losses {losses}")
    gbytes = walk_gather_bytes(cfg, RW_BATCH * cfg.walks_per_node)
    print(f"walk pass {label}: {n_batches} batches of {RW_BATCH} starts in {wall:.3f} s "
          f"({wall / n_batches * 1e3:.2f} ms a batch, the first with the pass's set-up), mean "
          f"loss {loss:.6f}; peak memory {peak / 2**30:.3f} GiB; 5 timed batches {ms:.2f} ms "
          f"a batch; the forward's gathered blocks {gbytes / 1e9:.2f} GB, twice that over "
          f"3.35 TB/s {2 * gbytes / 3.35e12 * 1e3:.2f} ms; launches {launches}", flush=True)
    device_breakdown(lambda: [batch() for _ in range(3)], f"walk pass {label} 3 batches",
                     3 * ms)
    return emb, dict(wall=wall, batches=n_batches, ms=ms, peak=peak)


def walk_stage2_vs_cpu(hin, model, embs, label):
    """One stage-2 step of `model`'s trainer on the card (the frozen
    embeddings `embs`, init(2020)'s parameters drawn without stage 1, a
    seeded batch whose last 100 rows are padding): its loss and every
    gradient against a CPU copy at WALK_TOL, the launches of the step and
    of an eval (none), the eval's HR@10 finite."""
    from graph_recsys_benchmark_tpu_torch.models.herec import herec_init
    from graph_recsys_benchmark_tpu_torch.models.walk import walk_init
    from graph_recsys_benchmark_tpu_torch.train import walk_trainers as W
    from graph_recsys_benchmark_tpu_torch.train.engine import fill_grads
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import TrainConfig

    cfg = walk_config(hin, "uid")
    gen_init = torch.Generator().manual_seed(2020)
    if model == "MetaPath2Vec":
        tr = W.MetaPath2VecTrainer(hin, cfg, TrainConfig(), device="cuda")
        tr.embedding = embs[0]
        params = walk_init(gen_init, cfg.embedding_dim).cuda()
    else:
        tr = W.HeRecTrainer(hin, cfg, TrainConfig(), device="cuda")
        tr.rk_embeddings = tuple(embs)
        params = herec_init(gen_init, hin.num_users, hin.num_items, cfg.embedding_dim,
                            len(embs)).cuda()
    bs = tr.tcfg.batch_size
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = tr._build_batch(torch.randperm(tr.n_rows, generator=gen, device="cuda")[:bs], gen)
    rmask = (torch.arange(bs, device="cuda") < bs - 100).float()
    cpu = copy.copy(tr)
    if model == "MetaPath2Vec":
        cpu.embedding = tr.embedding.cpu()
    else:
        cpu.rk_embeddings = tuple(e.cpu() for e in tr.rk_embeddings)
    ref = copy.deepcopy(params).cpu()
    loss = tr.batch_loss(params, batch, rmask)
    loss.backward()
    fill_grads(params)
    cpu_batch = tuple(b.cpu() for b in batch) if isinstance(batch, tuple) else batch.cpu()
    ref_loss = cpu.batch_loss(ref, cpu_batch, rmask.cpu())
    ref_loss.backward()
    fill_grads(ref)
    _, lrel = rel_err(loss.detach().cpu(), ref_loss.detach())
    errs = leaf_errors(label, params, ref)
    check(lrel <= WALK_TOL and errs[-1][0] <= WALK_TOL,
          f"{label} step vs CPU: loss rel {lrel}, worst leaf {errs[-1]} > {WALK_TOL}")
    opt = tr.optimizer(params)
    reset_launches()
    step_loss = tr.train_step(params, opt, torch.arange(bs, device="cuda"),
                              torch.ones(bs, device="cuda"), gen)
    m = tr.evaluate(params, gen)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == expected(), f"{label} step and eval: launches {launches}, expected none")
    check(bool(torch.isfinite(step_loss)) and np.isfinite(float(m["HR"][5])),
          f"{label}: step loss {step_loss}, HR@10 {m['HR'][5]}")
    print(f"walk stage 2 {label}: one step ({bs} rows, {tr.n_rows} a pass), loss "
          f"{float(loss.detach()):.6f}, vs CPU loss rel {lrel:.3e} worst leaf {errs[-1][1]} "
          f"{errs[-1][0]:.3e}; a step and an eval launch no repo kernel; HR@10 after a step "
          f"{float(m['HR'][5]):.4f}", flush=True)


def walk_phase(hin):
    """The walk models (MetaPath2Vec, HeRec) on the flagship HIN at the
    CLI's walk defaults: walks on the card bitwise the CPU's for the same
    uniforms (ML_MP2V_STEPS and the user-item metapath from the users, and
    the `synthetic-yelp` HeRec metapath 0, whose first relation has fewer
    rows than there are users); one pretraining batch's loss and gradient
    against a CPU copy; a timed pretraining pass for each of HeRec's
    metapaths (ms a batch, peak memory, busy share); one stage-2 step of
    each trainer against a CPU copy on those embeddings."""
    from graph_recsys_benchmark_tpu_torch.data.yelp import YELP_HEREC_METAPATHS
    from graph_recsys_benchmark_tpu_torch.train.walk_trainers import ML_HEREC_METAPATHS

    for k, steps in enumerate(ML_HEREC_METAPATHS):
        walks_vs_cpu(hin, steps, "uid", f"flagship HeRec metapath {k}")
    yelp = synthetic_yelp_hin()
    past = walks_vs_cpu(yelp, YELP_HEREC_METAPATHS[0], "uid", "synthetic-yelp HeRec metapath 0")
    check(past > 0, "synthetic-yelp HeRec metapath 0: no start past the first relation")
    walks_vs_cpu(yelp, YELP_HEREC_METAPATHS[0], "item_reviewcount",
                 "synthetic-yelp MetaPath2Vec")
    walk_batch_vs_cpu(hin, ML_HEREC_METAPATHS[0], "flagship ML_MP2V_STEPS")
    embs, out = [], {}
    for k, steps in enumerate(ML_HEREC_METAPATHS):
        emb, out[k] = walk_timed_pass(hin, steps, f"flagship HeRec metapath {k}")
        embs.append(emb)
    walk_stage2_vs_cpu(hin, "MetaPath2Vec", embs[:1], "MetaPath2Vec")
    walk_stage2_vs_cpu(hin, "HeRec", embs, "HeRec")
    return out


def import_phase(trainer, tmp):
    """A synthetic reference PEAGAT checkpoint at the flagship's shapes
    (pea_init(7)'s weights in the reference's layout and naming, a 30-epoch
    history, written by tests/torch_ckpt_files.py) imported on the card (utils/torch_import): its arrays bitwise
    the pea_init tree and a CPU import's; the flagship trainer's eval of the
    imported weights with every count set to 0 just before and read just
    after (flash_gat_fwd 1, batch_gat_fwd 2, as slice_phase's); the cached
    representation against the same forward of the CPU import
    (FORWARD_TOL) and the pair scores on it (KERNEL_TOL)."""
    from graph_recsys_benchmark_tpu_torch.models.params import to_numpy
    from graph_recsys_benchmark_tpu_torch.models.pea import pea_forward, pea_init, pea_predict
    from graph_recsys_benchmark_tpu_torch.utils.torch_import import import_reference_checkpoint

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_ckpt_files import reference_state_dict, write_reference_checkpoint

    cfg = trainer.cfg
    tree = to_numpy(pea_init(torch.Generator().manual_seed(7), cfg))
    tree["x"][cfg.num_nodes:] = 0.0  # the rows past the nodes: zeros in an import
    path = os.path.join(tmp, "latest.pkl")
    write_reference_checkpoint(path, reference_state_dict(tree, cfg), 30, seed=7)
    model, rec, epoch = import_reference_checkpoint(path, cfg, device="cuda")
    cpu_model, _, _ = import_reference_checkpoint(path, cfg, device="cpu")
    check(epoch == 30 and rec["HR"].shape == (30, 16), f"import: epoch {epoch}")
    check(all(p.device.type == "cuda" for p in model.parameters()), "import: not on the card")
    for got in (to_numpy(model), to_numpy(cpu_model)):
        for (name, a), b in zip(sorted(_leaves(got)), [v for _, v in sorted(_leaves(tree))]):
            check(np.array_equal(a, b), f"import: {name} differs from the checkpoint")
    gen = torch.Generator(device="cuda").manual_seed(0)
    reset_launches()
    res = trainer.evaluate(model, gen)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == expected(flash_fwd=1, batch_fwd=2),
          f"import eval: launches {launches}, expected flash_fwd 1, batch_fwd 2")
    with torch.no_grad():
        rep = trainer.eval_forward(model)
        cpu_rep = pea_forward(cpu_model, trainer.graphs.to("cpu"), cfg)
        users = trainer.tables.test_users.long()
        items = trainer.tables.test_items.long()
        scores = pea_predict(model, rep, users, items)
        cpu_scores = pea_predict(cpu_model, cpu_rep, users.cpu(), items.cpu())
    _, rrel = rel_err(rep.cpu(), cpu_rep)
    _, srel = rel_err(scores.cpu(), cpu_scores)
    check(rrel <= FORWARD_TOL["f32"] and srel <= FORWARD_TOL["f32"],
          f"import forward vs CPU: repr rel {rrel}, scores rel {srel}")
    print(f"import: a {len(tree['channels'])}-channel PEAGAT checkpoint ({cfg.num_nodes} nodes) on "
          f"the card, bitwise; eval launches {launches} HR@10 {float(res['HR'][5]):.4f} AUC "
          f"{float(res['AUC']):.4f}; repr vs the CPU import rel {rrel:.3e}, "
          f"{users.numel()} pair scores rel {srel:.3e}", flush=True)


def _leaves(tree, prefix=""):
    """(name, array) of every leaf of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], np.asarray(tree))]


WALK_MODELS = ("MetaPath2Vec", "HeRec")
WALK_YELP_ARGV = ["--dataset", "synthetic-yelp", "--runs", "1", "--epochs", "5"]
# the JAX CLI's results on a CPU (JAX_PLATFORMS=cpu; PERF.md section 2) for
# `--model M` + BASELINE_ARGV at the walk flags' defaults and + WALK_YELP_ARGV:
# (HR@10, NDCG@10, AUC)
WALK_JAX_CPU = {"MetaPath2Vec": (0.3053, 0.1607, 0.7241), "HeRec": (0.1667, 0.0838, 0.5707)}
WALK_JAX_CPU_YELP = {"MetaPath2Vec": (0.0478, 0.0271, 0.2795), "HeRec": (0.0510, 0.0364, 0.4487)}
# the same JAX CLI calls' train loss at the last epoch of each of the 5
# runs of `--model M` + BASELINE_ARGV (their logger_file.txt; BPR for
# MetaPath2Vec, HeRec's stage-2 MSE, which starts at 14.4-16.6 in epoch 1)
WALK_JAX_CPU_LAST_LOSS = {"MetaPath2Vec": (392.9886, 399.3532, 390.4069, 389.2782, 390.7646),
                          "HeRec": (2.1809, 1.9258, 1.8543, 1.9031, 1.7604)}


def loss_band(ref, runs):
    """The mean of the JAX CPU runs' losses `ref` +- 4 standard errors of
    the difference of two independent means, of `runs` and len(ref) runs,
    the per-run spread the sample standard deviation of `ref`."""
    ref = np.asarray(ref, np.float64)
    w = 4.0 * ref.std(ddof=1) * (1.0 / runs + 1.0 / ref.size) ** 0.5
    return (ref.mean() - w, ref.mean() + w)


def train_losses(lines):
    """{run: [train loss of epoch 1, 2, ...]} of a CLI log's epoch lines."""
    out = {}
    for ln in lines:
        m = re.match(r"Run: (\d+), epoch: (\d+), .*train loss: ([0-9.]+)", ln)
        if m:
            out.setdefault(int(m.group(1)), []).append(float(m.group(3)))
    return out


def walk_cli_phase(tmp):
    """The walk models through cli.main in process (cli_calls, every count
    set to 0 just before and read just after: none launched):
    `--model M` + BASELINE_ARGV (5 runs x 10 epochs at the walk defaults;
    each run pretrains: HeRec twice), the overall HR@10 within hr_band of
    the JAX CLI's CPU result and the runs' mean last-epoch train loss within
    loss_band of the JAX CLI's runs (an untrained HeRec reads HR@10 near a
    random scorer's 0.10, inside its HR band, and keeps its epoch-1 MSE of
    ~15); `--model M` + WALK_YELP_ARGV once each (MetaPath2Vec's walks from
    item_reviewcount), a finite overall HR@10 beside the JAX CLI's; every
    run's train loss lower at its last epoch than at its first; then MetaPath2Vec `--runs 1` and `--runs 2` into one run
    directory (run 1 resumed at run level, only seed 2021 pretrained) and a
    third call with other epochs (a new run directory) that reads both
    stage-1 embeddings from the cache and pretrains none."""
    from graph_recsys_benchmark_tpu_torch import cli
    from graph_recsys_benchmark_tpu_torch.train import walk_trainers as W

    argv_of, trainer_of, run = cli_calls(tmp)
    out = {}
    for model, base, refs, held in [(m, BASELINE_ARGV, WALK_JAX_CPU, True) for m in WALK_MODELS] + \
            [(m, WALK_YELP_ARGV, WALK_JAX_CPU_YELP, False) for m in WALK_MODELS]:
        label = f"cli {model} {base[1]}"
        argv = ["--model", model] + base
        tr, hin = trainer_of(argv, label)
        check(tr.device.type == "cuda", f"{label}: the CLI's trainer is on {tr.device}")
        overall, launches, wall, path, lines = run(argv, label)
        check(launches == expected(), f"{label}: launches {launches}, expected none")
        hr10, auc = float(overall["HR"][5]), float(np.ravel(overall["AUC"])[0])
        check(np.isfinite(hr10) and 0.0 <= hr10 <= 1.0, f"{label}: overall HR@10 {hr10}")
        runs, epochs = tr.tcfg.runs, tr.tcfg.epochs
        ref = refs[model]
        note = (f"the JAX CLI on a CPU: HR@10 {ref[0]}, NDCG@10 {ref[1]}, AUC {ref[2]}; "
                f"HR@10 {hr10 - ref[0]:+.4f}")
        losses = train_losses(lines)
        check(sorted(losses) == list(range(1, runs + 1))
              and all(len(v) == epochs and v[-1] < v[0] for v in losses.values()),
              f"{label}: train loss by run {losses}, each not falling over {epochs} epochs")
        last = float(np.mean([v[-1] for v in losses.values()]))
        note += ("; train loss by run, first -> last epoch: "
                 + ", ".join(f"{v[0]:.4f} -> {v[-1]:.4f}" for v in losses.values()))
        if held:
            band = hr_band(ref[0], hin.candidates.test_users.shape[0], runs)
            check(band[0] <= hr10 <= band[1], f"{label}: overall HR@10 {hr10} outside {band}")
            lband = loss_band(WALK_JAX_CPU_LAST_LOSS[model], runs)
            check(lband[0] <= last <= lband[1],
                  f"{label}: mean last-epoch train loss {last} outside {lband}")
            note += (f"; HR@10 band ({band[0]:.4f}, {band[1]:.4f}); mean last-epoch train "
                     f"loss {last:.4f}, JAX {np.mean(WALK_JAX_CPU_LAST_LOSS[model]):.4f}, band "
                     f"({lband[0]:.4f}, {lband[1]:.4f})")
        stage1 = [f for f in os.listdir(os.path.join(tmp, label, hin.name, model))
                  if f.endswith(".pt")]
        check(len(stage1) == runs * (2 if model == "HeRec" else 1),
              f"{label}: stage-1 files {stage1}")
        print(f"{label} ({runs} runs x {epochs} epochs, {tr.num_batches} steps an epoch, "
              f"{tr.cfg.num_start} walk starts from node {tr.cfg.start_offset}): overall "
              f"HR@10 {hr10:.4f} NDCG@10 {float(overall['NDCG'][5]):.4f} AUC {auc:.4f} "
              f"({note}); wall {wall:.2f} s; {len(stage1)} stage-1 files", flush=True)
        out[label] = dict(hr10=hr10, auc=auc, wall=wall, last_loss=last)

    # MetaPath2Vec: --runs 1, --runs 2 (run-level resume), then another run
    # directory over the same stage-1 cache
    seeds, real = [], W.pretrain_mp2v

    def spy(*args, **kw):
        seeds.append(args[3])
        return real(*args, **kw)

    label = "mp2v-resume"
    argv = ["--model", "MetaPath2Vec", "--dataset", "synthetic-ml", "--epochs", "2"]
    W.pretrain_mp2v = spy
    try:
        run(argv + ["--runs", "1"], label)
        check(seeds == [2020], f"{label} --runs 1: pretrained seeds {seeds}")
        _, _, _, path, lines = run(argv + ["--runs", "2"], label)
        check(seeds == [2020, 2021], f"{label} --runs 2: pretrained seeds {seeds}")
        trained = [ln for ln in lines if re.match(r"Run: 1, epoch: \d+,", ln)]
        check(len(trained) == 2, f"{label}: run 1 trained again: {trained}")
        reset_launches()
        cli.main(argv_of(argv + ["--runs", "2", "--lr", "0.002"], label))
        check(seeds == [2020, 2021] and read_launches() == expected(),
              f"{label} a new run directory: pretrained seeds {seeds}")
    finally:
        W.pretrain_mp2v = real
    print(f"{label}: --runs 1 pretrained seed 2020, --runs 2 resumed run 1 and pretrained "
          f"2021 alone; a new run directory (--lr 0.002) read both from the stage-1 cache",
          flush=True)
    return out


# ---------------------------------------------------------------- 12. parallel

PAR_TIMEOUT_S = 420  # each rank process of the parallel phase
# one step of the two-rank routes against the same code at a world of one:
# only the split and the order of the sums differ.  The loss is held to
# PAR_LOSS_TOL.  In f32 the median leaf is held to PAR_LEAF_TOL of its
# largest value, and every leaf to the JAX stream test's elementwise bars
# (stream_excess): a leaf that is a sum cancelling to a small value (a
# bias's, fc2.w) moves further when the batch's rows are split over the
# ranks (flagship channels.4.1.b 1.5e-4-2.1e-4 of its largest value,
# ML-25M fc2.w 1.1e-3), and by 2.6e-5-6.3e-5 between two runs of the same
# world-of-one step in one process, whose f32 atomics add in any order (on
# one H100 80GB HBM3 at 700 W; PERF.md section 6).  In bf16 every leaf is
# held to PAR_LEAF_TOL.  Two worlds of one (phase e) hold each leaf to
# PAR_LEAF_TOL or, where larger, PAR_SPREAD_X times its spread between two
# runs in one process.
PAR_LOSS_TOL = {"f32": 1e-6, "bf16": 1e-3}
PAR_LEAF_TOL = {"f32": 1e-5, "bf16": KINK_TOL}
PAR_SPREAD_X = 4.0
# one KGAT epoch against the single-process trainer's (par_phase_c): the
# JAX test's bars, but for the CF phase's mean train loss and HR@10, which
# the single-process trainer itself does not repeat to them: its f32
# atomics add in any order, and 281 CF steps amplify that (six f32 epochs
# from the same seeds read 432.29-432.60, 7e-4 apart, and HR@10
# 0.3117-0.3250, 8 users of 600, on one H100 80GB HBM3 at 700 W)
KG_EPOCH_BARS = {"train_loss": ("rtol", 2e-3), "kg_train_loss": ("rtol", 2e-4),
                 "AUC": ("atol", 5e-3), "HR@10": ("atol", 2e-2)}
# the streaming route against the single-process grouped forward: the JAX
# package's own bars (tests/test_stream_edge_sharded.py:97-104)
STREAM_LOSS_RTOL, STREAM_GRAD_RTOL, STREAM_GRAD_ATOL = 1e-5, 5e-3, 5e-4
PAR_STEPS = 3


def _free_port():
    import socket

    with socket.socket() as sk_:
        sk_.bind(("127.0.0.1", 0))
        return sk_.getsockname()[1]


def _start_ranks(kind, nprocs, workdir, argv=None):
    """Start `nprocs` processes (this script's rank worker `kind` over one
    TCP store, or `argv(r)`), each line printed with its rank as it comes
    -> [(kind, rank, process, lines, thread)]."""
    import threading

    store = f"tcp://127.0.0.1:{_free_port()}"
    started = []
    for r in range(nprocs):
        cmd = (argv(r) if argv is not None else
               [sys.executable, os.path.abspath(__file__), "--parallel-rank", kind, str(r),
                str(nprocs), store, workdir])
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             cwd=HERE)
        lines = []

        def pump(p=p, lines=lines, r=r):
            for line in p.stdout:
                lines.append(line.rstrip("\n"))
                sys.stdout.write(f"[{kind} rank {r}] {line.rstrip()}\n")  # one write a line
                sys.stdout.flush()

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        started.append((kind, r, p, lines, t))
    return started


def run_ranks(*groups, workdir=None, timeout=PAR_TIMEOUT_S):
    """Run every group (kind, nprocs[, argv]) of processes at once
    (_start_ranks) and wait for all: any process's failure or timeout kills
    the others and fails.  Returns {kind: each rank's output lines}."""
    procs = [x for g in groups for x in _start_ranks(g[0], g[1], workdir, *g[2:])]
    deadline = time.perf_counter() + timeout
    failed = None
    try:
        for kind, r, p, _, _ in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                failed = f"{kind}: rank {r} did not end within {timeout} s"
                break
            if p.returncode != 0:
                failed = f"{kind}: rank {r} exited {p.returncode}"
                break
    finally:
        for _, _, p, _, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for *_, t in procs:
            t.join(timeout=10)
    check(failed is None, failed)
    out = {}
    for kind, _, _, lines, _ in procs:
        out.setdefault(kind, []).append(lines)
    return out


def _grad_list(params):
    return [p.grad.detach().clone() for p in params.parameters()]


# a gradient leaf whose reference is no larger than this share of the
# largest reference gradient of all is a zero but for rounding: at the
# flagship's init the step-2 attention vectors of the seven channels that
# share i2u get exact zeros on the edge route and ~1e-11 on the hybrid
# plan (against 0.2 for fc2.w).  Such a leaf is held to the transport's
# PAR_LEAF_TOL of that largest gradient.
PAR_ZERO_FLOOR = 1e-7


def _par_leaf_errors(label, grads, ref_grads, names, transport, zeros=()):
    """{leaf: max |grads - ref| over the ref leaf's largest value}; a ref
    leaf at most PAR_ZERO_FLOOR of the largest ref gradient of all, or
    named in `zeros`, is held to PAR_LEAF_TOL[transport] of that largest
    gradient (and left out)."""
    top = max(float(r.abs().max()) for r in ref_grads)
    errs = {}
    for n, g, r in zip(names, grads, ref_grads):
        check(bool(torch.isfinite(g).all()), f"{label} grad {n}: not finite")
        if float(r.abs().max()) <= PAR_ZERO_FLOOR * top or n in zeros:
            err = float((g.to(r.device) - r).abs().max())
            check(err <= PAR_LEAF_TOL[transport] * top,
                  f"{label} grad {n}: a zero but for rounding in the reference, off by {err:.3e} "
                  f"(the largest gradient {top:.3e})")
            continue
        errs[n] = rel_err(g.to(r.device), r)[1]
    return errs


def _worst(errs):
    """(median, (worst error, leaf)) of a _par_leaf_errors dict."""
    vals = sorted((e, n) for n, e in errs.items())
    return vals[len(vals) // 2][0], vals[-1]


def stream_excess(grads, ref_grads, names):
    """{leaf: how far past rtol STREAM_GRAD_RTOL / atol STREAM_GRAD_ATOL
    (the JAX test_stream_edge_sharded.py bars) its worst element lies},
    the leaves within them left out."""
    excess = {}
    for n, g, r in zip(names, grads, ref_grads):
        over = float(((g - r).abs() - (STREAM_GRAD_ATOL + STREAM_GRAD_RTOL * r.abs())).max())
        if over > 0:
            excess[n] = over
    return excess


def hold_vs_world1(label, transport, loss, loss1, errs, spread, elementwise=None):
    """The loss within PAR_LOSS_TOL of the world of one's; each leaf within
    PAR_LEAF_TOL of its largest value or PAR_SPREAD_X times its spread
    between two world-of-one runs (`spread`, a _par_leaf_errors dict).
    `elementwise` {leaf: excess} replaces the leaf rule with an elementwise
    one the caller held (its leaves past it)."""
    rel_l = rel_err(loss, loss1)[1]
    med, worst = _worst(errs)
    if elementwise is not None:
        over = elementwise
        check(med <= PAR_LEAF_TOL[transport], f"{label}: median leaf vs a world of one {med}")
    else:
        over = {n: (e, spread.get(n, 0.0)) for n, e in errs.items()
                if e > max(PAR_LEAF_TOL[transport], PAR_SPREAD_X * spread.get(n, 0.0))}
    print(f"{label}: vs a world of one: loss {float(loss):.6f} / {float(loss1):.6f} rel "
          f"{rel_l:.3e}; leaves median {med:.3e} worst {worst}; the world of one against "
          f"itself run again: worst {_worst(spread)[1] if spread else None}", flush=True)
    check(rel_l <= PAR_LOSS_TOL[transport], f"{label}: loss vs a world of one {rel_l}")
    check(not over, f"{label}: leaves vs a world of one past their bar: {over}")
    return dict(loss_rel=rel_l, median_leaf=med, worst_leaf=worst[0], worst_name=worst[1],
                spread_worst=_worst(spread)[1][0] if spread else 0.0)


def probe_collectives(mesh):
    """Which collectives gloo serves on CUDA tensors (two ranks on one
    card): all_reduce SUM and MAX (the edge layer's) and the single-tensor
    all_to_all_single (f32, bf16, int32), all_gather_into_tensor and
    reduce_scatter_tensor (the row-sharded table's route,
    parallel/collectives.py), their values checked (a failure fails); the
    list all_gather, reduce_scatter and all_to_all reported.  Prints the
    route the row-sharded collectives take.  Returns {name: 'ok' | the
    error's first line}."""
    import torch.distributed as dist

    from graph_recsys_benchmark_tpu_torch.parallel.collectives import route

    dev, r = mesh.device, mesh.rank
    out = {}
    x = torch.full((4,), float(r + 1), device=dev)
    dist.all_reduce(x)
    check(torch.equal(x.cpu(), torch.full((4,), 3.0)), "gloo all_reduce SUM on cuda tensors")
    y = torch.full((4,), float(r + 1), device=dev)
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    check(torch.equal(y.cpu(), torch.full((4,), 2.0)), "gloo all_reduce MAX on cuda tensors")
    out["all_reduce"] = "ok (SUM, MAX)"
    want_a2a = torch.tensor([0., 1., 10., 11.]) + 2 * r
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        src = (torch.arange(4, device=dev) + 10 * r).to(dtype)
        got = torch.empty_like(src)
        dist.all_to_all_single(got, src)
        check(torch.equal(got.cpu().float(), want_a2a),
              f"gloo all_to_all_single {dtype} on cuda tensors: {got.cpu().tolist()}")
    out["all_to_all_single"] = "ok (f32, bf16, int32)"
    got = torch.empty(4, device=dev)
    dist.all_gather_into_tensor(got, torch.full((2,), float(r), device=dev))
    check(torch.equal(got.cpu(), torch.tensor([0., 0., 1., 1.])),
          "gloo all_gather_into_tensor on cuda tensors")
    out["all_gather_into_tensor"] = "ok"
    got = torch.empty(2, device=dev)
    dist.reduce_scatter_tensor(got, torch.arange(4, dtype=torch.float32, device=dev) * (r + 1))
    check(torch.equal(got.cpu(), torch.tensor([0., 3.]) + 6.0 * r),
          "gloo reduce_scatter_tensor on cuda tensors")
    out["reduce_scatter_tensor"] = "ok"
    probes = {
        "all_gather": lambda: dist.all_gather([torch.empty(4, device=dev) for _ in range(2)],
                                              torch.full((4,), float(r), device=dev)),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty(2, device=dev), [torch.ones(2, device=dev) for _ in range(2)]),
        "all_to_all": lambda: dist.all_to_all([torch.empty(2, device=dev) for _ in range(2)],
                                              [torch.ones(2, device=dev) for _ in range(2)]),
    }
    for name, fn in probes.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # a probe's refusal is its result
            out[name] = f"refused: {str(e).splitlines()[0][:160]}"
        dist.barrier()
    print(f"gloo on cuda tensors: {out}; the row-sharded route: {route(mesh)}", flush=True)
    return out


def _par_flagship(hin, transport, mesh):
    from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig
    from graph_recsys_benchmark_tpu_torch.parallel.engine import ShardedPEATrainer
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import TrainConfig

    cfg = PEAConfig(conv="gat", num_nodes=hin.num_nodes, meta_path_steps=(2,) * 9, emb_dim=64,
                    hidden_size=64, repr_dim=16, entity_aware=True)
    return cfg, ShardedPEATrainer(hin, cfg, TrainConfig(), mesh=mesh, transport=transport)


def _flagship_batch(trainer, seed=11):
    bs = trainer.tcfg.batch_size
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.randint(0, trainer.n_rows, (bs,), generator=gen, device="cuda")
    return trainer._build_batch(rows, gen), torch.ones(bs, device="cuda")


def record_calls(module, name):
    """A context that records the arguments of every call of
    module.<name> (its launches still counted on the original)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        calls, orig = [], getattr(module, name)

        def rec(*a, **k):
            calls.append((a, k))
            return orig(*a, **k)

        rec.launches = orig.launches
        setattr(module, name, rec)
        try:
            yield calls
        finally:
            setattr(module, name, orig)
            orig.launches = rec.launches
    return ctx()


def record_flash_calls(fn):
    """The arguments of every flash_gat_fwd (K1/K12) call of fn()."""
    from graph_recsys_benchmark_tpu_torch.ops import flash_gat as fg

    with record_calls(fg, "flash_gat_fwd") as calls:
        fn()
    torch.cuda.synchronize()
    return calls


def replay_flash_calls(calls, transport, label, bwd=False):
    """Each recorded K1/K12 call (or, `bwd`, K2 call) against its plain
    version (KERNEL_TOL of the largest value), its device, plain ms and
    bound (flash_fwd_cost, or flash_bwd_cost with the fused scatter, on
    the call's real edges) -> the kernels' JSON entry of the calls'
    sums."""
    from graph_recsys_benchmark_tpu_torch.ops import cost
    from graph_recsys_benchmark_tpu_torch.ops import flash_gat as fg

    if bwd:
        name, kernel, plain, n_args = "flash_gat_bwd", fg.flash_gat_bwd, fg.flash_gat_bwd_plain, 8
    else:
        name, kernel, plain, n_args = "flash_gat_fwd", fg.flash_gat_fwd, fg.flash_gat_fwd_plain, 7
    agg = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None)
    tb, tf = 0, 0
    for a, k in calls:
        table, src, dst, n, kz = a[0], *a[n_args - 4:n_args]
        got, want = kernel(*a, **k), plain(*a[:n_args])
        err, rel = check_kernel(f"{label} {name} kz {kz}", transport,
                                got if bwd else [got], want if bwd else [want])
        e = int((dst < n).sum())
        isz = table.element_size()
        flops, nbytes = (cost.flash_bwd_cost(e, kz, n, table.shape[0], isz, True) if bwd
                         else cost.flash_fwd_cost(e, kz, n, table.shape[0], isz))
        ms = device_ms(lambda: kernel(*a, **k))
        plain_ms = device_ms(lambda: plain(*a[:n_args]), reps=5)
        b_ms, b_by = bound_ms(nbytes, flops)
        print(f"{label} {name} {transport}: kz {kz} rows {n} edges {e} (padded "
              f"{dst.numel()}) rel_err {rel:.3e} ms {ms:.5f} plain_ms {plain_ms:.4f} bound_ms "
              f"{b_ms:.6f} ({b_by})", flush=True)
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        agg["ms"] += ms
        agg["plain_ms"] += plain_ms
        agg["bound_ms"] += b_ms
        tb, tf = tb + nbytes, tf + flops
    agg["bound_by"] = bound_ms(tb, tf)[1]
    agg["calls"] = len(calls)
    return agg


def par_phase_a(hin, mesh, transport, workdir):
    """Flagship PEAGAT, edge mode, on `mesh` (two ranks sharing cuda:0 over
    gloo): one step's launches against the shard plan, its loss and
    all-reduced gradients against the same code at a world of one (rank 0)
    and the single-process PEATrainer (the hybrid plan), PAR_STEPS steps
    with bitwise-equal parameter digests on both ranks, step and all-reduce
    ms, the eval's launches (rank 0), and K7/K5/K6 at the union shards and
    K1/K12 on the eval's unions timed (rank 0)."""
    import torch.distributed as dist

    from graph_recsys_benchmark_tpu_torch.parallel import collectives as coll
    from graph_recsys_benchmark_tpu_torch.parallel.edge_parallel import (
        _local_view,
        make_edge_sharded_train_step,
        shard_step_graph,
        sharded_grads,
    )
    from graph_recsys_benchmark_tpu_torch.parallel.mesh import Mesh
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer

    lab = f"parallel a {transport}"
    r = mesh.rank
    t0 = time.perf_counter()
    cfg, sh = _par_flagship(hin, transport, mesh)
    graphs = sh._edge_graphs
    print(f"{lab}: trainer built in {time.perf_counter() - t0:.1f} s host; this rank's union "
          f"shards (rows, real edges, padded) "
          f"{[(g.num_nodes, int((g.dst < g.num_nodes).sum()), g.dst.numel()) for g in graphs]}",
          flush=True)
    names = [n for n, _ in sh.init(2020).named_parameters()]
    params = sh.init(2020)
    batch, mask = _flagship_batch(sh)
    # one step's launches: per union shard K7 3 (gather_src, gather_dst,
    # the sum's backward), K5 2 (the sum, gather_dst's backward), K6 1
    # (gather_src's backward); the sharded softmax is plain torch
    want = expected(gather=3 * len(graphs), segsum=2 * len(graphs), scatter=len(graphs))
    reset_launches()
    loss = sh.loss_and_grads(params, batch, mask)
    torch.cuda.synchronize()
    got = read_launches()
    print(f"{lab}: one step's launches {got}", flush=True)
    check(got == want, f"{lab}: launches {got}, the shard plan's {want}")
    grads = _grad_list(params)
    digests = coll.gather_digests(grads, mesh)
    check(len(set(digests)) == 1, f"{lab}: the ranks' all-reduced gradients differ")
    res = {"launches_step": got, "loss": float(loss)}
    if r == 0:
        # the same code at a world of one: one shard, no collective
        one = Mesh(dp=1, rank=0, device=mesh.device)
        g1 = tuple(_local_view(shard_step_graph(g, 1), one) for g in sh.graphs)
        step1, _ = make_edge_sharded_train_step(cfg, g1, one, transport)
        runs = []
        for _ in range(2):
            p1 = sh.init(2020)
            runs.append((sharded_grads(step1.local_loss, p1, batch, mask, one), _grad_list(p1)))
        (loss1, grads1), (_, grads1b) = runs
        torch.save({"loss": loss1.cpu(), "grads": [g.cpu() for g in grads1]},
                   os.path.join(workdir, f"world1_{transport}.pt"))
        w1 = hold_vs_world1(lab, transport, loss, loss1,
                            _par_leaf_errors(lab, grads, grads1, names, transport),
                            _par_leaf_errors(lab, grads1b, grads1, names, transport),
                            stream_excess(grads, grads1, names) if transport == "f32"
                            else None)
        # the single-process trainer, hybrid plan, same weights and batch
        base = PEATrainer(hin, cfg, sh.tcfg, device="cuda", transport=transport)
        ref = _one_batch(base, sh.init(2020), batch, mask)
        rel_h = rel_err(loss, ref[0])[1]
        hmed, hworst = _worst(_par_leaf_errors(lab, grads, [p.grad for p in
                                                            ref[1].parameters()], names,
                                               transport))
        # mode_slice_phase's bars between routes: the loss and the median
        # leaf at FORWARD_TOL, every leaf at KINK_TOL; in bf16 the
        # gradients printed, as there for a route of another softmax shift
        # (this route's exact row max against the hybrid plan's bound)
        print(f"{lab}: vs the single-process PEATrainer (hybrid plan): loss rel {rel_h:.3e}; "
              f"leaves median {hmed:.3e} worst {hworst}", flush=True)
        check(rel_h <= FORWARD_TOL[transport], f"{lab}: loss vs the hybrid plan {rel_h}")
        check(transport == "bf16" or (hmed <= FORWARD_TOL[transport] and hworst[0] <= KINK_TOL),
              f"{lab}: vs the hybrid plan: median {hmed}, worst {hworst}")
        res.update(world1=w1, hybrid_loss_rel=rel_h, hybrid_median_leaf=hmed,
                   hybrid_worst_leaf=hworst[0])
        del base, ref, p1, g1, runs
    dist.barrier()
    # PAR_STEPS optimizer steps through the trainer's own train_step
    opt = sh.optimizer(params)
    gen = torch.Generator(device="cuda").manual_seed(12)
    step_ms, ar = [], []
    for i in range(PAR_STEPS):
        rows = torch.randint(0, sh.n_rows, (sh.tcfg.batch_size,), generator=gen, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i == PAR_STEPS - 1:
            coll.reset_stats()
            with coll.timing():
                sh.train_step(params, opt, rows, mask, gen)
            ar.append(dict(coll.STATS))
        else:
            sh.train_step(params, opt, rows, mask, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    pd = coll.gather_digests(list(params.parameters()), mesh)
    print(f"{lab}: {PAR_STEPS} steps, ms {[round(x, 2) for x in step_ms]} (the last with every "
          f"collective timed: {ar[0]['calls']} all-reduces, {ar[0]['bytes']} bytes, "
          f"{ar[0]['seconds'] * 1e3:.3f} ms); parameter digests {pd}", flush=True)
    check(len(set(pd)) == 1, f"{lab}: the ranks' parameters differ after {PAR_STEPS} steps")
    res.update(step_ms=step_ms, allreduce=ar[0], digests=pd)
    # one all-reduce of the step's gradient buffer, timed alone (20 calls)
    flat = torch.cat([p.grad.reshape(-1) for p in params.parameters()])
    dist.barrier()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        coll.all_reduce_(flat, mesh)
    torch.cuda.synchronize()
    res["grad_allreduce_ms"] = (time.perf_counter() - t) * 1e3 / 20
    print(f"{lab}: the gradient all-reduce alone ({flat.numel() * 4} bytes) "
          f"{res['grad_allreduce_ms']:.3f} ms a call", flush=True)
    # K7/K5/K6 at this rank's union shards: one step's calls recorded on
    # both ranks (the step's collectives need both), replayed on rank 0
    calls = record_edge_calls(sh)
    if r == 0:
        res["edge_kernels"] = {k: v for (k, _), v in replay_edge_calls(
            calls, transport, f"parallel flagship union shard (rank 0 of 2)").items()}
        reset_launches()
        flash = record_flash_calls(lambda: sh.evaluate(params, torch.Generator(
            device="cuda").manual_seed(13)))
        ev = read_launches()
        want_ev = expected(flash_fwd=2)
        print(f"{lab}: an eval's launches (rank 0, the union graphs) {ev}", flush=True)
        check(ev == want_ev, f"{lab}: eval launches {ev}, expected {want_ev}")
        res["eval_launches"] = ev
        res["flash"] = replay_flash_calls(flash, transport, "parallel eval union")
    del calls
    dist.barrier()
    del sh
    torch.cuda.empty_cache()
    return res


def par_phase_b(mesh, transport, workdir, loaded):
    """The ML-25M regime's streaming route on `mesh`: each rank's shards of
    the per-channel graphs (plan_channel_shards) through K9-K11 with
    make_stream_edge_sharded_train_step directly (no ShardedPEATrainer:
    its eval graphs, a 13-channel union with the loops as edges, are not
    built), one step's launches against the plan's groups, its loss and
    gradients against the single-process grouped forward at the JAX bars
    and a world of one at phase a's (rank 0), step ms, and K9-K11 at the
    shards' shapes (rank 0)."""
    import torch.distributed as dist

    from graph_recsys_benchmark_tpu_torch.graph import graphs_to
    from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig, pea_init, pea_loss
    from graph_recsys_benchmark_tpu_torch.parallel import collectives as coll
    from graph_recsys_benchmark_tpu_torch.parallel.edge_parallel import (
        _local_view,
        make_stream_edge_sharded_train_step,
        plan_channel_shards,
        sharded_grads,
    )
    from graph_recsys_benchmark_tpu_torch.parallel.mesh import Mesh
    from graph_recsys_benchmark_tpu_torch.train.engine import GraphEpochEngine
    from graph_recsys_benchmark_tpu_torch.train.optim import make_optimizer
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import TrainConfig
    from graph_recsys_benchmark_tpu_torch.train.sampling import build_device_tables

    lab = f"parallel b {transport}"
    hin, per_channel = loaded["hin"], loaded["per_channel"]
    cfg = PEAConfig(conv="gat", num_nodes=hin.num_nodes, meta_path_steps=(2,) * 13,
                    emb_dim=64, hidden_size=64, repr_dim=16, entity_aware=True)
    tcfg = TrainConfig(batch_size=4096, sampling_strategy="random")
    if "plan" not in loaded:
        t0 = time.perf_counter()
        groups, dist_ = plan_channel_shards(per_channel, mesh.dp)
        loaded["plan"] = (groups, tuple(tuple(_local_view(d, mesh) for d in s) for s in dist_))
        loaded["engine"] = GraphEpochEngine(build_device_tables(hin, mesh.device), tcfg,
                                            batch_loss=None, entity_aware=True)
        print(f"{lab}: shard plan and tables in {time.perf_counter() - t0:.1f} s host; groups "
              f"{groups}", flush=True)
    groups, local = loaded["plan"]
    eng = loaded["engine"]
    step, place = make_stream_edge_sharded_train_step(cfg, groups, local, mesh, transport)
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = torch.randint(0, eng.n_rows, (tcfg.batch_size,), generator=gen, device="cuda")
    batch, mask = eng._build_batch(rows, gen), torch.ones(tcfg.batch_size, device="cuda")
    params = pea_init(torch.Generator().manual_seed(2020), cfg).to(mesh.device)
    names = [n for n, _ in params.named_parameters()]
    n_groups = sum(len(g) for g in groups)
    want = expected(stream_fwd=n_groups, stream_bwd_dst=n_groups, stream_bwd_src=n_groups)
    reset_launches()
    loss = sharded_grads(step.local_loss, params, *place(batch, mask), mesh)
    torch.cuda.synchronize()
    got = read_launches()
    print(f"{lab}: one step's launches {got} ({n_groups} channel groups)", flush=True)
    check(got == want, f"{lab}: launches {got}, the plan's {want}")
    grads = _grad_list(params)
    res = {"launches_step": got, "loss": float(loss)}
    if mesh.rank == 0:
        one = Mesh(dp=1, rank=0, device=mesh.device)
        if "plan1" not in loaded:
            g1, d1 = plan_channel_shards(per_channel, 1)
            loaded["plan1"] = (g1, tuple(tuple(_local_view(d, one) for d in s) for s in d1))
        step1, _ = make_stream_edge_sharded_train_step(cfg, *loaded["plan1"], one, transport)
        runs = []
        for _ in range(2):
            p1 = pea_init(torch.Generator().manual_seed(2020), cfg).to(mesh.device)
            runs.append((sharded_grads(step1.local_loss, p1, batch, mask, one), _grad_list(p1)))
        (loss1, grads1), (_, grads1b) = runs
        w1 = hold_vs_world1(lab, transport, loss, loss1,
                            _par_leaf_errors(lab, grads, grads1, names, transport),
                            _par_leaf_errors(lab, grads1b, grads1, names, transport),
                            stream_excess(grads, grads1, names) if transport == "f32"
                            else None)
        del p1, step1, runs
        # the single-process grouped forward (models/pea._grouped_gat_forward)
        p2 = pea_init(torch.Generator().manual_seed(2020), cfg).to(mesh.device)
        on_card = graphs_to(per_channel, mesh.device)
        loss2 = pea_loss(p2, on_card, cfg, batch, row_mask=mask, transport=transport)
        loss2.backward()
        rel_g = rel_err(loss, loss2.detach())[1]
        gmed, gworst = _worst(_par_leaf_errors(lab, grads, [p.grad for p in p2.parameters()],
                                               names, transport))
        excess = stream_excess(grads, [p.grad for p in p2.parameters()], names)
        print(f"{lab}: vs the single-process grouped forward: loss {float(loss):.4f} / "
              f"{float(loss2):.4f} rel {rel_g:.3e}; leaves median {gmed:.3e} worst {gworst}; "
              f"past rtol {STREAM_GRAD_RTOL} / atol {STREAM_GRAD_ATOL}: {excess}", flush=True)
        check(rel_g <= STREAM_LOSS_RTOL, f"{lab}: loss vs the grouped forward {rel_g}")
        # f32: the JAX test's elementwise bars.  bf16, which that test does
        # not run: the two routes make z in other products (one einsum a
        # group against a matmul a channel), so a table entry can round to
        # bf16 apart, and sums that cancel (the step-1 biases: 16 % on
        # channels.11.0.b on one H100 80GB HBM3 at 700 W) amplify it:
        # mode_slice_phase's rule for routes that round apart, the loss and
        # the median leaf held (FORWARD_TOL), every leaf printed
        check(not excess if transport == "f32" else gmed <= FORWARD_TOL[transport],
              f"{lab}: gradients vs the grouped forward: {excess or gmed}")
        res.update(world1=w1, grouped_loss_rel=rel_g, grouped_median_leaf=gmed,
                   grouped_worst_leaf=gworst[0], grouped_excess=excess)
        del p2, on_card, loss2
    dist.barrier()
    opt = make_optimizer(tcfg.opt, tcfg.lr, tcfg.weight_decay)(params.parameters())
    step_ms = []
    for i in range(2):
        rows = torch.randint(0, eng.n_rows, (tcfg.batch_size,), generator=gen, device="cuda")
        b = eng._build_batch(rows, gen)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i == 1:
            coll.reset_stats()
            with coll.timing():
                step(params, opt, *place(b, mask))
            ar = dict(coll.STATS)
        else:
            step(params, opt, *place(b, mask))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    pd = coll.gather_digests(list(params.parameters()), mesh)
    check(len(set(pd)) == 1, f"{lab}: the ranks' parameters differ")
    print(f"{lab}: 2 steps ms {[round(x, 2) for x in step_ms]} (the last with every "
          f"collective timed: {ar['calls']} all-reduces, {ar['bytes']} bytes, "
          f"{ar['seconds'] * 1e3:.3f} ms); parameter digests equal", flush=True)
    res.update(step_ms=step_ms, allreduce=ar)
    if mesh.rank == 0 and transport == "f32":
        # K9-K11 at this rank's shards (each call's real edges), f32
        from graph_recsys_benchmark_tpu_torch.models.pea import _channel_layer_dims

        dims = _channel_layer_dims(cfg, 2)
        stream = []
        for k, step_groups in enumerate(groups):
            for chans, gi in step_groups:
                g = local[k][gi]
                real = int((g.dst < g.num_nodes).sum())
                stream.append((f"step {k + 1}", dataclasses.replace(g, num_edges=real), chans,
                               dims[k][1]))
        t0 = time.perf_counter()
        res["stream_kernels"] = {f"{k}|{t}": v for (k, t), v in ml25m_kernel_phase(
            None, stream, [], label="parallel ml25m shard (rank 0 of 2)", sweep=False,
            reps=5, plain_reps=1, transports=("f32",)).items() if k != "softmax"}
        print(f"{lab}: K9-K11 at the shards timed in {time.perf_counter() - t0:.1f} s",
              flush=True)
    dist.barrier()
    torch.cuda.empty_cache()
    return res


def par_phase_c(hin, mesh, transport):
    """KGAT edge-sharded on `mesh` at the CLI's widths (emb 64, hidden 64)
    and TrainConfig's defaults: one CF step's launches against the shard
    plan and its loss against the single-process KGTrainer's step
    (PAR_LOSS_TOL, rank 0); one epoch's train_loss and kg_train_loss and
    the eval's HR@10 and AUC against the single-process trainer at the
    same seeds (rank 0), at KG_EPOCH_BARS; the ranks' parameters bitwise
    equal."""
    import torch.distributed as dist

    from graph_recsys_benchmark_tpu_torch.models.kg import KGConfig
    from graph_recsys_benchmark_tpu_torch.parallel import collectives as coll
    from graph_recsys_benchmark_tpu_torch.parallel.engine import make_sharded_kg_trainer
    from graph_recsys_benchmark_tpu_torch.train.baseline_trainers import KGTrainer
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import TrainConfig

    lab = f"parallel c {transport}"
    cfg = KGConfig(variant="kgat", num_nodes=hin.num_nodes, num_relations=hin.num_edge_types,
                   emb_dim=64, hidden_size=64)
    tcfg = TrainConfig()
    sh = make_sharded_kg_trainer(hin, cfg, tcfg, mesh, transport=transport)
    params = sh.init(2020)
    batch, mask = _flagship_batch(sh)
    att = sh._att_snapshot(params)
    reset_launches()
    loss = sh._step(params, sh.optimizer(params),
                    lambda: sh._cf_loss(params, att, batch, mask, None))
    torch.cuda.synchronize()
    got = read_launches()
    want = expected(gather=6, segsum=3, scatter=3)
    print(f"{lab}: one CF step's launches {got}", flush=True)
    check(got == want, f"{lab}: launches {got}, the plan's {want}")
    res = {"launches_step": got}
    single = None
    if mesh.rank == 0:
        single = KGTrainer(hin, cfg, tcfg, device="cuda", transport=transport)
        ps = single.init(2020)
        loss1 = single._step(ps, single.optimizer(ps), lambda: single._cf_loss(
            ps, single._att_snapshot(ps), batch, mask, None))
        rel = rel_err(loss, loss1)[1]
        print(f"{lab}: one CF step's loss {float(loss):.6f} / single-process "
              f"{float(loss1):.6f} rel {rel:.3e}", flush=True)
        check(rel <= PAR_LOSS_TOL[transport], f"{lab}: a CF step's loss vs one process {rel}")
        res["step_loss_rel"] = rel
    out = {}
    for name, tr in (("sharded", sh), ("single", single)):
        if tr is None:
            break
        p = tr.init(2020)
        o = tr.optimizer(p)
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses = tr.run_epoch(p, o, torch.Generator(device="cuda").manual_seed(31))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        m = tr.evaluate(p, torch.Generator(device="cuda").manual_seed(32))
        out[name] = dict(train_loss=float(losses["train_loss"]),
                         kg_train_loss=float(losses["kg_train_loss"]),
                         HR=m["HR"].cpu().numpy(), AUC=float(m["AUC"]), secs=secs)
        if name == "sharded":
            pd = coll.gather_digests(list(p.parameters()), mesh)
            check(len(set(pd)) == 1, f"{lab}: the ranks' parameters differ after an epoch")
        print(f"{lab}: {name} epoch {secs:.2f} s: train loss {out[name]['train_loss']:.6f} kg "
              f"train loss {out[name]['kg_train_loss']:.6f} HR@10 {out[name]['HR'][5]:.4f} "
              f"AUC {out[name]['AUC']:.4f}", flush=True)
    if mesh.rank == 0:
        a, b = out["sharded"], out["single"]
        n_users = sh.tables.test_users.shape[0]
        for x in (a, b):
            x["HR@10"] = float(x["HR"][5])
        diff = {k: abs(a[k] - b[k]) for k in KG_EPOCH_BARS}
        # HR@10 is a count of users over n_users: its difference is taken
        # in users, so that a difference of exactly the bar (2e-2: 12 of
        # 600) is not pushed past it by the float32 rounding of two shares
        diff["HR@10"] = abs(round(a["HR@10"] * n_users) - round(b["HR@10"] * n_users)) / n_users
        bars = {k: (diff[k], tol * abs(b[k]) if kind == "rtol" else tol)
                for k, (kind, tol) in KG_EPOCH_BARS.items()}
        print(f"{lab}: sharded vs single (difference, bar): {bars}; the largest difference "
              f"over HR@1-16 {float(np.abs(a['HR'] - b['HR']).max()) * n_users:.0f} of "
              f"{n_users} users", flush=True)
        for k, (d, bar) in bars.items():
            check(d <= bar, f"{lab}: {k} off the single-process trainer's by {d} > {bar}")
        res.update({k: (a[k], b[k]) for k in ("train_loss", "kg_train_loss", "AUC", "HR@10")},
                   epoch_s=(a["secs"], b["secs"]))
    dist.barrier()
    return res


# ------------------------------------------------ 12f-h. the row-sharded table

ROW_SHARDED_STEPS = 2  # timed steps a case (phases f and h)
# a 99-negative or full-catalog rank may differ from the single-process
# evaluator's only where the positive ties a candidate within this share
# of its score (the two sum a score's terms in other orders)
EVAL_TIE = 1e-6


def a2a_launches(cfg, step=True):
    """A rank's launches of one a2a step (or, step False, one eval
    forward and its cached-row lookup) from parallel/a2a.py: a step
    position's static lookups (GAT: [z | a_src] by src and a_dst by dst;
    GCN, SAGE: the source rows) gather twice each (K7: the serve rows,
    then the pick from the received buffer) and its sum is one K5; the
    batch's dynamic lookups (cached rows; entity-aware also x's) gather
    twice each.  Backward: each gather's K6, each K5's K7."""
    steps = cfg.meta_path_steps[0]
    static = 2 if cfg.conv == "gat" else 1
    if not step:
        return expected(gather=steps * 2 * static + 2, segsum=steps)
    dynamic = 2 if cfg.entity_aware else 1
    return expected(gather=steps * (2 * static + 1) + 2 * dynamic,
                    scatter=steps * 2 * static + 2 * dynamic, segsum=steps)


def _flagship_cfg(hin, conv="gat"):
    from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig

    return PEAConfig(conv=conv, num_nodes=hin.num_nodes, meta_path_steps=(2,) * 9, emb_dim=64,
                     hidden_size=64, repr_dim=16, entity_aware=True)


def _whole_grads(params, mesh, axis):
    """_grad_list with x's gradient, this rank's rows, all-gathered."""
    from graph_recsys_benchmark_tpu_torch.parallel.collectives import full_rows

    grads = _grad_list(params)
    grads[0] = full_rows(grads[0], mesh, axis)
    return grads


def _hold_row_sharded(lab, transport, sh, sh1, params, loss, batch, mask, axis, mesh,
                      zeros=(), seed=None):
    """The step's loss and gradients (x's re-assembled) against the same
    code at a world of one (`sh1`, run twice for the spread; with `seed`,
    each run's dropout masks drawn from a generator of that seed on the
    batch's device, as the step's were), rank 0 -> (hold_vs_world1's result, the leaves held
    as zeros but for rounding: _par_leaf_errors' floor and `zeros`,
    printed); (None, ()) on the other ranks."""
    names = [n for n, _ in params.named_parameters()]
    check(names[0] == "x", f"{lab}: x is not the first parameter")
    grads = _whole_grads(params, mesh, axis)
    if mesh.rank != 0:
        return None, ()
    runs = []
    for _ in range(2):
        p1 = sh1.init(2020)
        gen = None if seed is None else torch.Generator(device=batch.device).manual_seed(seed)
        runs.append((sh1.loss_and_grads(p1, batch, mask, gen), _grad_list(p1)))
    (loss1, grads1), (_, grads1b) = runs
    top = max(float(r.abs().max()) for r in grads1)
    floor = {n: (float(r.abs().max()) / top, float((g - r).abs().max()) / top)
             for n, g, r in zip(names, grads, grads1)
             if float(r.abs().max()) <= PAR_ZERO_FLOOR * top or n in zeros}
    print(f"{lab}: zeros but for rounding (the leaf's largest reference value and its error, "
          f"over the largest gradient {top:.4e}): {floor}", flush=True)
    return hold_vs_world1(lab, transport, loss, loss1,
                          _par_leaf_errors(lab, grads, grads1, names, transport, zeros),
                          _par_leaf_errors(lab, grads1b, grads1, names, transport, zeros),
                          stream_excess(grads, grads1, names) if transport == "f32"
                          else None), tuple(floor)


def par_phase_f(hin, mesh):
    """`--parallel a2a` on `mesh` (two ranks sharing cuda:0 over gloo): the
    flagship PEAGAT in f32 and bf16, then PEAGCN and PEASage in f32,
    through ShardedPEATrainer(mode='a2a'): each rank's plan capacities
    and shards, one step's launches against a2a_launches, its collectives
    (calls and bytes by name, seconds under timing()), its loss and
    gradients (x's halves together) against the same code at a world of
    one (rank 0; the edge phases' bars: hold_vs_world1); for PEAGAT
    ROW_SHARDED_STEPS timed steps and K7/K5/K6 at one step's shapes
    against their plain versions (replay_edge_calls, rank 0), and in f32
    the eval (phase g)."""
    import torch.distributed as dist

    from graph_recsys_benchmark_tpu_torch.parallel import collectives as coll
    from graph_recsys_benchmark_tpu_torch.parallel.engine import ShardedPEATrainer
    from graph_recsys_benchmark_tpu_torch.parallel.mesh import Mesh
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import TrainConfig

    res = {}
    for conv, transport in (("gat", "f32"), ("gat", "bf16"), ("gcn", "f32"), ("sage", "f32")):
        lab = f"parallel f a2a {conv} {transport}"
        cfg = _flagship_cfg(hin, conv)
        t0 = time.perf_counter()
        sh = ShardedPEATrainer(hin, cfg, TrainConfig(), mesh=mesh, mode="a2a",
                               transport=transport)
        setup = sh._a2a["setup"]
        print(f"{lab}: built in {time.perf_counter() - t0:.1f} s host; r_loc "
              f"{setup['r_loc']}, s_virt {setup['s_virt']}, v_total {setup['v_total']}; this "
              f"rank's shards (real edges, padded) "
              f"{[(int((g.dst < g.num_nodes).sum()), g.dst.numel()) for g in setup['graphs']]};"
              f" plan capacities src {[p['capacity'] for p in setup['src_plans']]} dst "
              f"{[p and p['capacity'] for p in setup['dst_plans']]}", flush=True)
        params = sh.init(2020)
        batch, mask = _flagship_batch(sh)
        want = a2a_launches(cfg)
        reset_launches()
        coll.reset_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with coll.timing():
            loss = sh.loss_and_grads(params, batch, mask)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        got = read_launches()
        stats = dict(coll.STATS, ops={k: list(v) for k, v in coll.STATS["ops"].items()})
        print(f"{lab}: one step's launches {got}; collectives {stats['ops']} ([calls, bytes "
              f"sent] by name), {stats['seconds'] * 1e3:.3f} ms of {step_s * 1e3:.2f} ms",
              flush=True)
        check(got == want, f"{lab}: launches {got}, a2a_launches' {want}")
        r = dict(launches_step=got, collectives=stats, step_ms_timed=step_s * 1e3,
                 capacities=[p["capacity"] for p in setup["src_plans"]])
        sh1 = None
        if mesh.rank == 0:
            sh1 = ShardedPEATrainer(hin, cfg, TrainConfig(), mode="a2a", transport=transport,
                                    mesh=Mesh(dp=1, rank=0, device=mesh.device))
        r["world1"], _ = _hold_row_sharded(lab, transport, sh, sh1, params, loss, batch, mask,
                                           "dp", mesh)
        del sh1
        dist.barrier()
        if conv == "gat":
            opt = sh.optimizer(params)
            gen = torch.Generator(device="cuda").manual_seed(12)
            step_ms = []
            for _ in range(ROW_SHARDED_STEPS):
                rows = torch.randint(0, sh.n_rows, (sh.tcfg.batch_size,), generator=gen,
                                     device="cuda")
                torch.cuda.synchronize()
                t = time.perf_counter()
                sh.train_step(params, opt, rows, mask, gen)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
            print(f"{lab}: {ROW_SHARDED_STEPS} steps, ms {[round(x, 2) for x in step_ms]}",
                  flush=True)
            r["step_ms"] = step_ms
            calls = record_edge_calls(sh)  # both ranks: the step's exchanges need both
            if mesh.rank == 0:
                r["edge_kernels"] = {k: v for (k, _), v in replay_edge_calls(
                    calls, transport, f"a2a flagship (rank 0 of 2)").items()}
            del calls
            dist.barrier()
            if transport == "f32":
                t = time.perf_counter()
                r["eval"] = par_phase_g(sh, params, mesh)
                r["eval_s"] = time.perf_counter() - t
        res[f"{conv}|{transport}"] = r
        del sh, params
        torch.cuda.empty_cache()
    return res


def _neg_tie_gaps(users, score, tables, neg):
    """For each test user index in `users`: the smallest |s(negative) -
    s(positive)| / |s(positive)| over its sampled negatives."""
    gaps = []
    for k in users:
        u, p = tables.test_users[k:k + 1], tables.test_items[k:k + 1]
        s_pos = score(u, p)
        s_n = score(u.repeat(neg.shape[1]), neg[k])
        gaps.append(float(((s_n - s_pos).abs() / s_pos.abs().clamp_min(1e-30)).min()))
    return gaps


def par_phase_g(sh, params, mesh):
    """The a2a evaluator on the flagship PEAGAT (f32): an eval's launches
    (a2a_launches(step=False)), then (rank 0) its 99-negative ranks and
    metrics against the single-process evaluator (eval/ranking.py, the
    same generator) and its full-catalog sweep's ranks against
    eval/full_ranking.py, both over the same cached representation (the
    ranks' rows all-gathered): equal but for users whose positive ties a
    candidate within EVAL_TIE."""
    from graph_recsys_benchmark_tpu_torch.eval.full_ranking import evaluate_full_ranking
    from graph_recsys_benchmark_tpu_torch.eval.ranking import evaluate_ranking
    from graph_recsys_benchmark_tpu_torch.models.pea import pea_predict
    from graph_recsys_benchmark_tpu_torch.parallel.collectives import full_rows
    from graph_recsys_benchmark_tpu_torch.train.sampling import sample_eval_negatives

    lab = "parallel g a2a eval f32"
    seed = 13
    reset_launches()
    ev = sh.evaluate(params, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    got = read_launches()
    want = a2a_launches(sh.cfg, step=False)
    check(got == want, f"{lab}: launches {got}, expected {want}")
    full = sh.evaluate_full(params)
    with torch.no_grad():
        cached = full_rows(sh._a2a["local_cached"](params), mesh, "dp")
    out = dict(launches=got, HR10=float(ev["HR"][5]), AUC=float(ev["AUC"]),
               full_HR10=float(full["HR"][5]))
    if mesh.rank != 0:
        return out
    tables = sh.tables
    check(tables.mode == "dense", "the near-tie check reads dense tables")

    def score(u, i):
        return pea_predict(params, cached, u.long(), i.long())

    with torch.no_grad():
        ref = evaluate_ranking(torch.Generator(device="cuda").manual_seed(seed), score, tables,
                               num_candidates=sh.tcfg.num_neg_candidates)
        neg = sample_eval_negatives(torch.Generator(device="cuda").manual_seed(seed), tables,
                                    sh.tcfg.num_neg_candidates)
        differ = torch.nonzero(ev["ranks"] != ref["ranks"]).flatten().tolist()
        gaps = _neg_tie_gaps(differ, score, tables, neg)
        fref = evaluate_full_ranking(score, tables)
        fdiffer = torch.nonzero(full["ranks"] != fref["ranks"]).flatten().tolist()
        fgaps = _near_tie_users(fdiffer, tables, score)
    n = int(tables.test_users.shape[0])
    print(f"{lab}: launches {got}; 99 negatives: HR@10 {out['HR10']:.4f} / single-process "
          f"{float(ref['HR'][5]):.4f}, NDCG@10 {float(ev['NDCG'][5]):.4f} / "
          f"{float(ref['NDCG'][5]):.4f}, AUC {out['AUC']:.4f} / {float(ref['AUC']):.4f}, "
          f"eval loss {float(ev['eval_loss']):.5f} / {float(ref['eval_loss']):.5f}; "
          f"{len(differ)} of {n} users' ranks differ (near ties {gaps}); full catalog: "
          f"HR@10 {out['full_HR10']:.4f} / {float(fref['HR'][5]):.4f}, {len(fdiffer)} of {n} "
          f"users' ranks differ (near ties {fgaps})", flush=True)
    check(all(g <= EVAL_TIE for g in gaps),
          f"{lab}: 99-negative ranks apart beyond ties: users {differ}, gaps {gaps}")
    check(all(g <= EVAL_TIE for g in fgaps),
          f"{lab}: full-catalog ranks apart beyond ties: users {fdiffer}, gaps {fgaps}")
    out.update(differ=len(differ), full_differ=len(fdiffer), users=n,
               single_HR10=float(ref["HR"][5]), single_full_HR10=float(fref["HR"][5]))
    return out


# the dp dropout step's generator seed (the same on every rank and in the
# world of one: the same masks)
DP_DROPOUT_SEED = 21
# one composed union GAT step's launches under dropout (_per_channel_step's
# counts of a composed conv); the flagship has two such steps
DP_DROPOUT_STEP = dict(softmax=2, gather=10, segsum=6, scatter=2)


def par_phase_h_dropout(hin, cfg, m2, mesh, transport, batch, mask, loss0, zeros):
    """The dp step with attention dropout DROPOUT (flagship PEAGAT at mp 2,
    `batch` and the parameters of par_phase_h's step): its launches (the
    union graphs' composed route, DP_DROPOUT_STEP, no flash kernel), its
    masks' kept share (drawn again from DP_DROPOUT_SEED: within 4 sigma of
    1 - DROPOUT), its loss (printed beside the no-dropout step's `loss0`:
    at the init's near-constant scores the masks move it by ~1e-5) and
    gradients against a world of one drawing the same masks (`zeros`: the
    f32 dropout step's zeros but for rounding, held as zeros in bf16), and
    (rank 0) the step's K8, K7, K5 and K6 calls against their plain
    versions, timed -> (result, the zeros)."""
    import torch.distributed as dist

    from graph_recsys_benchmark_tpu_torch.models.pea import DropoutMasks
    from graph_recsys_benchmark_tpu_torch.parallel.engine import ShardedPEATrainer
    from graph_recsys_benchmark_tpu_torch.parallel.mesh import Mesh
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import TrainConfig

    lab = f"parallel h dp mp 2 {transport} dropout {DROPOUT}"
    cfg = dataclasses.replace(cfg, dropout=DROPOUT)
    sh = ShardedPEATrainer(hin, cfg, TrainConfig(), mesh=m2, mode="dp", transport=transport)
    params = sh.init(2020)
    reset_launches()
    with edge_calls_recorded() as edge, softmax_calls_recorded() as soft:
        loss = sh.loss_and_grads(params, batch, mask,
                                 torch.Generator(device="cuda").manual_seed(DP_DROPOUT_SEED))
        torch.cuda.synchronize()
    got = read_launches()
    want = expected(**DP_DROPOUT_STEP)  # every flash counter 0
    # the step's masks, drawn again in its order (one head a step here)
    masks = DropoutMasks(DROPOUT, torch.Generator(device="cuda").manual_seed(DP_DROPOUT_SEED))
    keep = torch.cat([masks.union(k, g, 1).flatten() for k, g in enumerate(sh.graphs)])
    kept = float(keep.float().mean())
    moved = rel_err(loss, loss0)[1]
    print(f"{lab}: one step's launches {got}; masks of {keep.numel()} edges, kept share "
          f"{kept:.5f}; loss {float(loss):.6f}, without dropout {float(loss0):.6f} (rel "
          f"{moved:.3e})", flush=True)
    check(got == want, f"{lab}: launches {got}, expected {want}")
    check(abs(kept - (1 - DROPOUT)) <= 4 * (DROPOUT * (1 - DROPOUT) / keep.numel()) ** 0.5,
          f"{lab}: kept share {kept}")
    r = dict(launches_step=got, kept=kept, loss_moved=moved)
    sh1 = None
    if mesh.rank == 0:
        sh1 = ShardedPEATrainer(hin, cfg, TrainConfig(), mode="dp", transport=transport,
                                mesh=Mesh(dp=1, rank=0, device=mesh.device))
    r["world1"], zeros = _hold_row_sharded(lab, transport, sh, sh1, params, loss, batch, mask,
                                           "mp", m2, zeros, seed=DP_DROPOUT_SEED)
    if mesh.rank == 0:
        label = "parallel dp dropout union (rank 0 of 2)"
        r["edge_kernels"] = {k: v for (k, _), v in replay_edge_calls(
            edge, transport, label).items()}
        for kind, v in r["edge_kernels"].items():
            check(v["calls"] == got[kind], f"{lab} {kind}: {v['calls']} calls recorded, "
                  f"{got[kind]} launches")
        r["softmax"] = replay_softmax_calls(soft, f"{label} {transport}")
    del sh, sh1, params, edge, soft
    dist.barrier()
    torch.cuda.empty_cache()
    return r, zeros


def par_phase_h(hin, mesh):
    """`--parallel dp` at mp 2 (dp 1 x mp 2 on the two ranks sharing the
    card): per transport the flagship PEAGAT through
    ShardedPEATrainer(mode='dp'): one step's launches (the union graphs
    over the all-gathered table: K12/K1 2, K2 2), its loss and gradients
    (x's mp shards together) against the same code at a world of one
    (rank 0, hold_vs_world1), ROW_SHARDED_STEPS timed steps (the collectives
    timed), one eval (launches K12/K1 2; its metrics against the world of
    one's), (rank 0) the step's K12/K1 and K2 calls against their
    plain versions, timed, and the same step with attention dropout
    (par_phase_h_dropout).

    The bf16 step rounds each rank's rows' cotangent to bf16 in the flash
    backward, where the world of one rounds their sum: a leaf that is zero
    but for rounding carries bf16 noise of another draw (the step-2
    attention vectors of the seven channels sharing i2u: 1.6e-12-3.6e-11
    of the largest gradient in f32, 1.4e-7-2.2e-6 in bf16, and 0.45-0.74
    of that apart on one H100 80GB HBM3 at 700 W; PERF.md section 6).  So
    the leaves that the f32 step finds zero (PAR_ZERO_FLOOR) are held as
    zeros in bf16 too."""
    import torch.distributed as dist

    from graph_recsys_benchmark_tpu_torch.ops import flash_gat as fg
    from graph_recsys_benchmark_tpu_torch.parallel import collectives as coll
    from graph_recsys_benchmark_tpu_torch.parallel import multihost as mh
    from graph_recsys_benchmark_tpu_torch.parallel.engine import ShardedPEATrainer
    from graph_recsys_benchmark_tpu_torch.parallel.mesh import Mesh
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import TrainConfig

    m2 = mh.make_pod_mesh(mp=2)
    check((m2.dp, m2.mp, m2.axis_index("mp")) == (1, 2, mesh.rank),
          f"parallel h: mesh {m2.dp} x {m2.mp}, m {m2.axis_index('mp')} on rank {mesh.rank}")
    res = {}
    cfg = _flagship_cfg(hin)
    zeros = ()  # the f32 step's zeros but for rounding, held as zeros in bf16
    zeros_d = ()  # the same of the dropout step
    for transport in TDT:
        lab = f"parallel h dp mp 2 {transport}"
        sh = ShardedPEATrainer(hin, cfg, TrainConfig(), mesh=m2, mode="dp", transport=transport)
        params = sh.init(2020)
        check(params.x.shape[0] == cfg.emb_rows // 2, f"{lab}: x rows {params.x.shape[0]}")
        batch, mask = _flagship_batch(sh)
        reset_launches()
        with record_calls(fg, "flash_gat_fwd") as fwd, record_calls(fg, "flash_gat_bwd") as bwd:
            loss = sh.loss_and_grads(params, batch, mask)
            torch.cuda.synchronize()
        got = read_launches()
        want = expected(flash_fwd=2, flash_bwd=2)
        print(f"{lab}: one step's launches {got}", flush=True)
        check(got == want, f"{lab}: launches {got}, expected {want}")
        r = dict(launches_step=got)
        sh1 = None
        if mesh.rank == 0:
            sh1 = ShardedPEATrainer(hin, cfg, TrainConfig(), mode="dp", transport=transport,
                                    mesh=Mesh(dp=1, rank=0, device=mesh.device))
        r["world1"], zeros = _hold_row_sharded(lab, transport, sh, sh1, params, loss, batch,
                                               mask, "mp", m2, zeros)
        reset_launches()
        ev = sh.evaluate(params, torch.Generator(device="cuda").manual_seed(13))
        torch.cuda.synchronize()
        ev_launches = read_launches()
        check(ev_launches == expected(flash_fwd=2), f"{lab}: eval launches {ev_launches}")
        r.update(eval_launches=ev_launches, HR10=float(ev["HR"][5]), AUC=float(ev["AUC"]))
        if mesh.rank == 0:
            p1 = sh1.init(2020)
            ev1 = sh1.evaluate(p1, torch.Generator(device="cuda").manual_seed(13))
            print(f"{lab}: eval launches {ev_launches}; HR@10 {r['HR10']:.4f} AUC "
                  f"{r['AUC']:.4f}; a world of one's {float(ev1['HR'][5]):.4f} "
                  f"{float(ev1['AUC']):.4f}", flush=True)
            check(abs(r["HR10"] - float(ev1["HR"][5])) <= 5e-3
                  and abs(r["AUC"] - float(ev1["AUC"])) <= 5e-3,
                  f"{lab}: eval against a world of one's")
            r["flash_fwd"] = replay_flash_calls(fwd, transport, "parallel dp union")
            r["flash_bwd"] = replay_flash_calls(bwd, transport, "parallel dp union", bwd=True)
        dist.barrier()
        opt = sh.optimizer(params)
        gen = torch.Generator(device="cuda").manual_seed(12)
        step_ms = []
        for i in range(ROW_SHARDED_STEPS):
            rows = torch.randint(0, sh.n_rows, (sh.tcfg.batch_size,), generator=gen,
                                 device="cuda")
            coll.reset_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with coll.timing():
                sh.train_step(params, opt, rows, mask, gen)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        stats = dict(coll.STATS, ops={k: list(v) for k, v in coll.STATS["ops"].items()})
        print(f"{lab}: {ROW_SHARDED_STEPS} steps, ms {[round(x, 2) for x in step_ms]}; the last's "
              f"collectives {stats['ops']} ([calls, bytes sent]), {stats['seconds'] * 1e3:.3f} "
              "ms", flush=True)
        r.update(step_ms=step_ms, collectives=stats)
        del sh, sh1, params, fwd, bwd
        dist.barrier()
        torch.cuda.empty_cache()
        r["dropout"], zeros_d = par_phase_h_dropout(hin, cfg, m2, mesh, transport, batch, mask,
                                                    loss, zeros_d)
        res[transport] = r
    return res


def _json_safe(x):
    if isinstance(x, dict):
        return {str(k): _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


def parallel_rank_main(kind, rank, world, store, workdir):
    """One rank of the parallel phase's worlds ('world': phases a-c, the
    probe and f-h, two ranks sharing cuda:0 over gloo; 'nccl': phase e, a
    world of one over NCCL, after the refused layout).  Writes its results to
    <workdir>/<kind>_<rank>.json."""
    import pickle

    from graph_recsys_benchmark_tpu_torch.parallel import collectives as coll
    from graph_recsys_benchmark_tpu_torch.parallel import multihost as mh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    res = {}
    if kind == "nccl":
        # two ranks asking for NCCL on one card: refused, the layout named,
        # before any process group starts
        try:
            mh.initialize_runtime(store, 2, 0, backend="nccl")
            refused = None
        except ValueError as e:
            refused = str(e)
        print(f"NCCL asked for with two ranks on {torch.cuda.device_count()} card(s): "
              f"{refused}", flush=True)
        check(refused is not None and "2 local ranks on 1 card" in refused,
              "NCCL with two ranks on one card was not refused with the layout named")
        res["refused"] = refused
    check(mh.initialize_runtime(store, world, rank) is True, f"{kind}: no runtime")
    want_backend = "nccl" if kind == "nccl" else "gloo"
    check(mh.RUNTIME["backend"] == want_backend,
          f"{kind}: backend {mh.RUNTIME['backend']}, expected {want_backend}")
    mesh = mh.make_pod_mesh(mp=1)
    hin = flagship_hin()
    if kind == "world":
        t = time.perf_counter()
        res["a"] = {tr: par_phase_a(hin, mesh, tr, workdir) for tr in TDT}
        res["a_s"] = time.perf_counter() - t
        t = time.perf_counter()
        with open(os.path.join(workdir, "ml25m.pkl"), "rb") as f:
            loaded = pickle.load(f)
        res["b"] = {tr: par_phase_b(mesh, tr, workdir, loaded) for tr in TDT}
        res["b_s"] = time.perf_counter() - t
        del loaded
        torch.cuda.empty_cache()
        t = time.perf_counter()
        res["c"] = {tr: par_phase_c(hin, mesh, tr) for tr in TDT}
        res["c_s"] = time.perf_counter() - t
        res["probe"] = probe_collectives(mesh)
        t = time.perf_counter()
        res["f"] = par_phase_f(hin, mesh)
        res["f_s"] = time.perf_counter() - t
        t = time.perf_counter()
        res["h"] = par_phase_h(hin, mesh)
        res["h_s"] = time.perf_counter() - t
    else:
        # phase a's world-of-one step through this NCCL world, against the
        # gloo world's rank 0 (world1_<transport>.pt)
        import torch.distributed as dist

        from graph_recsys_benchmark_tpu_torch.parallel.edge_parallel import sharded_grads

        for transport in TDT:
            cfg, sh = _par_flagship(hin, transport, mesh)
            params = sh.init(2020)
            batch, mask = _flagship_batch(sh)
            loss = sharded_grads(sh._edge_step.local_loss, params, batch, mask, mesh)
            grads = _grad_list(params)
            flat = torch.cat([g.reshape(-1) for g in grads])
            before = flat.clone()
            dist.all_reduce(flat)  # NCCL's all-reduce of one rank
            torch.cuda.synchronize()
            check(torch.equal(flat, before), "nccl: an all-reduce of one rank changed it")
            ref = torch.load(os.path.join(workdir, f"world1_{transport}.pt"))
            same = bool(torch.equal(loss.cpu(), ref["loss"]) and all(
                torch.equal(g.cpu(), h) for g, h in zip(grads, ref["grads"])))
            # the kernels' f32 atomics add in any order: a repeat of the same
            # step in this process, to tell that from the backend
            p2 = sh.init(2020)
            loss2 = sharded_grads(sh._edge_step.local_loss, p2, batch, mask, mesh)
            again = bool(torch.equal(loss, loss2) and all(
                torch.equal(g, p.grad) for g, p in zip(grads, p2.parameters())))
            names = [n for n, _ in params.named_parameters()]
            print(f"parallel e {transport}: the world-of-one step over NCCL bitwise gloo's: "
                  f"{same}; the same step twice in this process bitwise: {again}", flush=True)
            check(same or not again, f"parallel e {transport}: NCCL's world of one differs "
                  "from gloo's while its own repeat is bitwise")
            w1 = hold_vs_world1(f"parallel e {transport} (NCCL against gloo)", transport,
                                loss.cpu(), ref["loss"],
                                _par_leaf_errors("parallel e", [g.cpu() for g in grads],
                                                 ref["grads"], names, transport),
                                _par_leaf_errors("parallel e", [p.grad.cpu() for p in
                                                                p2.parameters()],
                                                 [g.cpu() for g in grads], names, transport))
            res[transport] = dict(bitwise=same, repeat_bitwise=again, world1=w1,
                                  stats=dict(coll.STATS))
            del sh, params, p2
            torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_all
    with open(os.path.join(workdir, f"{kind}_{rank}.json"), "w") as f:
        json.dump(_json_safe(res), f)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def _cli_log(out_dir):
    """(per-epoch train losses, overall HR@10, the log's path) of a CLI
    run's only log."""
    log, lines = _log_lines(out_dir)
    losses = [float(re.search(r"train loss: ([-0-9.]+)", ln).group(1)) for ln in lines
              if ln.startswith("Run: ") and "train loss:" in ln]
    hr = [float(re.search(r"HR@10: ([0-9.]+)", ln).group(1)) for ln in lines
          if ln.startswith("Overall")]
    return losses, hr, log


# phase d's CLI modes: (the two ranks' flags, the one process's flags)
CLI_MODES = {"edge": (["--parallel", "edge"], ["--parallel", "edge"]),
             "a2a": (["--parallel", "a2a"], ["--parallel", "a2a"]),
             # the one process's world of one takes mp 1 (an odd world)
             "dp": (["--parallel", "dp", "--mesh_mp", "2"], ["--parallel", "dp"])}


def par_phase_d(tmp, work):
    """`python -m graph_recsys_benchmark_tpu_torch --parallel edge`,
    `--parallel a2a` and `--parallel dp --mesh_mp 2` beside each other
    (CLI_MODES), each as two processes (ranks 0 and 1 sharing the card
    over gloo; rank 1 given an --out_dir of its own, where it must write no
    file) and, at the same time, the same mode in one process: each
    epoch's train loss within 1e-4 relative, the overall HR@10 within
    2/150.  Then a resume of every mode by both ranks from rank 0's
    checkpoints (its run marked unfinished): no epoch trained, the overall
    line the first call's; phase e's world of one over NCCL runs beside
    the resumes (neither is timed)."""
    base = ["--model", "PEAGAT", "--dataset", "synthetic-ml", "--runs", "1", "--epochs", "5",
            "--save_every_epoch", "0"]

    def ranks(mode, out_of, cache):
        port = _free_port()

        def argv(r):
            return [sys.executable, "-m", "graph_recsys_benchmark_tpu_torch", *base,
                    *CLI_MODES[mode][0], "--cache_dir", cache, "--out_dir", out_of(r),
                    "--dist_coordinator", f"127.0.0.1:{port}", "--dist_nprocs", "2",
                    "--dist_rank", str(r)]
        return argv

    def single(mode):
        return lambda r: [sys.executable, "-m", "graph_recsys_benchmark_tpu_torch", *base,
                          *CLI_MODES[mode][1], "--cache_dir",
                          os.path.join(tmp, f"hin_single_{mode}"), "--out_dir",
                          os.path.join(tmp, f"d_single_{mode}")]

    def rank_dir(mode, r):
        return os.path.join(tmp, f"d_{mode}_rank{r}")

    t = time.perf_counter()
    run_ranks(*[x for mode in CLI_MODES for x in (
        (f"cli-{mode}", 2, ranks(mode, lambda r, m=mode: rank_dir(m, r),
                                 os.path.join(tmp, f"hin_{mode}"))),
        (f"cli-{mode}-single", 1, single(mode)))])
    res = {"calls_s": time.perf_counter() - t}
    for mode in CLI_MODES:
        files1 = [os.path.join(d, f) for d, _, fs in os.walk(rank_dir(mode, 1)) for f in fs]
        check(not files1, f"parallel d {mode}: rank 1 wrote {files1}")
        losses2, hr2, log = _cli_log(rank_dir(mode, 0))
        losses1, hr1, _ = _cli_log(os.path.join(tmp, f"d_single_{mode}"))
        ckpts = sorted(os.listdir(os.path.join(os.path.dirname(log), "run_1")))
        check({"latest.ckpt", "epoch_5.ckpt"} <= set(ckpts),
              f"parallel d {mode}: checkpoints {ckpts}")
        print(f"parallel d {mode}: two ranks and one process side by side (every mode at "
              f"once) {res['calls_s']:.1f} s; train losses {losses2} / {losses1}; overall "
              f"HR@10 {hr2} / {hr1}; rank 0's checkpoints {ckpts}, rank 1's directory empty",
              flush=True)
        check(len(losses2) == len(losses1) == 5, f"parallel d {mode}: five epochs each")
        for x, y in zip(losses2, losses1):
            check(abs(x - y) <= 1e-4 * abs(y), f"parallel d {mode}: train loss {x} vs {y}")
        check(abs(hr2[0] - hr1[0]) <= 2 / 150 + 1e-9, f"parallel d {mode}: HR@10 {hr2} vs {hr1}")
        res[mode] = dict(losses=(losses2, losses1), hr10=(hr2, hr1))
    # resume: each run 1 unfinished in the summary, its checkpoints in place
    firsts = {}
    for mode in CLI_MODES:
        _, lines = _log_lines(rank_dir(mode, 0))
        firsts[mode] = [ln for ln in lines if ln.startswith("Overall")][0]
        run = os.path.dirname(_cli_log(rank_dir(mode, 0))[2])
        os.remove(os.path.join(run, "global_logger.npz"))
    t = time.perf_counter()
    outs = run_ranks(*[(f"cli-resume-{mode}", 2, ranks(mode, lambda r, m=mode: rank_dir(m, 0),
                                                       os.path.join(tmp, f"hin_{mode}")))
                       for mode in CLI_MODES], ("nccl", 1), workdir=work)
    res["resume_and_e_s"] = time.perf_counter() - t
    for mode in CLI_MODES:
        overall = [[ln for ln in o if ln.startswith("Overall HR@10")]
                   for o in outs[f"cli-resume-{mode}"]]
        first = firsts[mode]
        print(f"parallel d {mode}: resume (beside the other modes' and phase e) "
              f"{res['resume_and_e_s']:.1f} s: {overall}", flush=True)
        check(all(len(o) == 1 and o[0].split(",")[:3] == first.split(" (")[0].split(",")[:3]
                  for o in overall), f"parallel d {mode}: the resumed overall {overall} vs "
              f"{first}")
    return res


def parallel_phase(tmp, ml25m_pickle):
    """Parallel training (parallel/, --parallel edge, a2a, dp): phases a-c,
    the probe and f-h in one two-rank world sharing cuda:0 over gloo
    (par_phase_a, _b, _c per transport; probe_collectives; par_phase_f
    with g, par_phase_h), d the CLI as processes, e a world of one over
    NCCL (after the refused NCCL layout) beside d's resumes.  Prints each
    phase's seconds and the whole's."""
    t0 = time.perf_counter()
    work = os.path.join(tmp, "parallel")
    os.makedirs(work, exist_ok=True)
    os.replace(ml25m_pickle, os.path.join(work, "ml25m.pkl"))
    run_ranks(("world", 2), workdir=work)
    res = [json.load(open(os.path.join(work, f"world_{r}.json"))) for r in range(2)]
    t_d = time.perf_counter()
    res_d = par_phase_d(tmp, work)
    res_e = json.load(open(os.path.join(work, "nccl_0.json")))
    t_end = time.perf_counter()
    print(f"parallel phases {t_end - t0:.1f} s: a-c, f-h {t_d - t0:.1f} s (a {res[0]['a_s']:.1f}, "
          f"b {res[0]['b_s']:.1f}, c {res[0]['c_s']:.1f}, f {res[0]['f_s']:.1f}, h "
          f"{res[0]['h_s']:.1f} by rank 0's clock), d and e {t_end - t_d:.1f} s (d's calls "
          f"{res_d['calls_s']:.1f} s, the resumes and e "
          f"{res_d['resume_and_e_s']:.1f} s)", flush=True)
    return res, res_d, res_e


def main():
    t_start = time.perf_counter()
    if len(sys.argv) > 1 and sys.argv[1] == "--parallel-rank":
        # one rank of parallel_phase's worlds (run_ranks)
        sys.path.insert(0, HERE)
        kind, rank, world, store, workdir = sys.argv[2:7]
        return parallel_rank_main(kind, int(rank), int(world), store, workdir)
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
    timed("PEAGAT dropout", dropout_phase, hin, trainers["f32"])
    pres = timed("per-channel", per_channel_phase, hin)
    timed("profiling and roofline", profiling_phase, trainers, smi)
    beres, bkres, blaunch = timed("baselines", baselines_phase, hin)
    timed("walk models", walk_phase, hin)
    with tempfile.TemporaryDirectory() as tmp:
        timed("checkpoint import", import_phase, trainers["f32"], tmp)
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
    # kept on the host for parallel_phase b: the HIN and the per-channel graphs
    from graph_recsys_benchmark_tpu_torch.graph import graphs_to

    ml25m_kept = {"hin": hin25, "per_channel": graphs_to(trainers25["f32"].graphs, "cpu")}
    del hin25, trainers25
    torch.cuda.empty_cache()

    ykres, yeres, yres, _ = timed("yelp", yelp_phases)
    torch.cuda.empty_cache()

    t_c = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cres = cli_phase(tmp)
        timed("cli archive", archive_cli_phase, tmp)
        timed("cli datasets", cli_datasets_phase, tmp)
        timed("cli baselines", baselines_cli_phase, tmp)
        timed("cli walk models", walk_cli_phase, tmp)
    print(f"cli phases {time.perf_counter() - t_c:.1f} s", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        import pickle

        t_p = time.perf_counter()
        path = os.path.join(tmp, "ml25m.pkl")
        with open(path, "wb") as f:
            pickle.dump(ml25m_kept, f, protocol=4)
        del ml25m_kept
        print(f"parallel: the ML-25M HIN and graphs pickled in "
              f"{time.perf_counter() - t_p:.1f} s", flush=True)
        pres_w, pres_d, pres_e = parallel_phase(tmp, path)

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
    composed_calls = {"ML-25M": "15 composed convs of one forward",
                      "Yelp": "9 composed convs of one forward"}
    for regime, kres_, steps_ in (("ML-25M", mkres, mres), ("Yelp", ykres, yres)):
        for (kind, transport), r in kres_.items():
            where, src_file, name, calls = replaces[kind]
            if kind == "softmax":
                calls = composed_calls[regime]
            kernels.append(dict(
                name=f"{name} ({transport}; {regime}, {calls})", route="cuda",
                source=f"{csrc}/{src_file}", replaces=f"{repo}/ops/{where}",
                # the regime's 8 timed steps
                launches=steps_[transport]["launches"][kind], max_abs_err=r["max_abs_err"],
                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
            ))
    replaces = {"segsum": "77", "gather": "426", "scatter": "636"}
    for regime, eres_, steps_ in (("ML-25M", meres, mres), ("Yelp", yeres, yres)):
        for (kind, transport), r in eres_.items():
            kernels.append(dict(
                name=f"{SEG_KERNELS[kind]} ({transport}; {regime}, {r['calls']} calls of one "
                     "step)",
                route="cuda", source=f"{csrc}/segment.cu",
                replaces=f"{repo}/ops/pallas_segment.py:{replaces[kind]}",
                # the regime's 8 timed steps
                launches=steps_[transport]["launches"][kind], max_abs_err=r["max_abs_err"],
                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
            ))
    # the per-channel path (mixed table): launches those of one step
    pea = {"gcn": "PEAGCN", "sage": "PEASage", "gat": "PEAGAT"}
    lines = {"segsum": "77", "gather": "426", "scatter": "636", "softmax": "244"}
    for (kind, conv, transport), r in pres["kernels"].items():
        name = SEG_KERNELS.get(kind, "softmax_stats")
        kernels.append(dict(
            name=f"{name} ({transport}; per-channel {pea[conv]}, meta_path_steps (1,) + "
                 f"(2,) * 8, {r['calls']} calls of one step)",
            route="cuda", source=f"{csrc}/segment.cu",
            replaces=f"{repo}/ops/pallas_segment.py:{lines[kind]}",
            launches=pres["launches"][(conv, "mixed", transport)][kind],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    # the baselines: launches those of the model's timed run (10 steps, for
    # KGAT a KG epoch, and an eval; the KG graph's entries KGAT's run)
    bpath = {"ngcf": ("NGCF", "NGCF"), "kg": ("KGAT", "KGAT and KGCN")}
    for (kind, conv, transport), r in beres.items():
        model, what = bpath[conv]
        kernels.append(dict(
            name=f"{SEG_KERNELS[kind]} ({transport}; {what} on the flagship's {conv.upper()} "
                 f"graph: {' + '.join(r['shapes'])}; launches of {model}'s timed run)",
            route="cuda", source=f"{csrc}/segment.cu",
            replaces=f"{repo}/ops/pallas_segment.py:{lines[kind]}",
            launches=blaunch[(model, transport)][kind], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    for model, r in bkres.items():
        kernels.append(dict(
            name=f"softmax_stats (f32; {model} attention map on the flagship's KG graph; "
                 f"launches of {model}'s timed run)",
            route="cuda", source=f"{csrc}/segment.cu",
            replaces=f"{repo}/ops/pallas_segment.py:{lines['softmax']}",
            launches=blaunch[(model, "f32")]["softmax"], max_abs_err=r["max_abs_err"],
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
    # the edge-parallel route (parallel_phase): launches those of one step
    # (or, for K1/K12, one eval) of one rank of two sharing the card
    r0 = pres_w[0]
    for transport in TDT:
        a = r0["a"][transport]
        for kind, r in a["edge_kernels"].items():
            kernels.append(dict(
                name=f"{SEG_KERNELS[kind]} ({transport}; PEAGAT --parallel edge, rank 0 of 2 "
                     f"on one card: its shards of the flagship's two union graphs, "
                     f"{r['calls']} calls of one step)",
                route="cuda", source=f"{csrc}/segment.cu",
                replaces=f"{repo}/ops/pallas_segment.py:{lines[kind]}",
                launches=a["launches_step"][kind], max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"]))
        f = a["flash"]
        kernels.append(dict(
            name=f"flash_gat_fwd ({transport}; the edge-mode eval's union graphs, kz 64 and "
                 "16)", route="cuda", source=f"{csrc}/gat_fwd.cu",
            replaces=f"{repo}/ops/flash_gat.py:" + ("479" if transport == "bf16" else "129"),
            launches=a["eval_launches"]["flash_fwd"], max_abs_err=f["max_abs_err"],
            ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
            bound_by=f["bound_by"], library_ms=None))
    # the row-sharded modes (parallel_phase f, h): launches those of one
    # step of one rank of two sharing the card
    for transport in TDT:
        f = r0["f"][f"gat|{transport}"]
        for kind, r in f["edge_kernels"].items():
            kernels.append(dict(
                name=f"{SEG_KERNELS[kind]} ({transport}; PEAGAT --parallel a2a, rank 0 of 2 on "
                     f"one card: its shards of the flagship's interleaved unions and its "
                     f"lookups, {r['calls']} calls of one step)",
                route="cuda", source=f"{csrc}/segment.cu",
                replaces=f"{repo}/ops/pallas_segment.py:{lines[kind]}",
                launches=f["launches_step"][kind], max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"]))
        h = r0["h"][transport]
        for kind, src_file, line in (("flash_fwd", "gat_fwd.cu",
                                      "479" if transport == "bf16" else "129"),
                                     ("flash_bwd", "gat_bwd.cu", "829")):
            r = h[kind]
            kernels.append(dict(
                name=f"flash_gat_{kind[6:]} ({transport}; PEAGAT --parallel dp --mesh_mp 2, "
                     f"rank 0 of 2 on one card: the union graphs over the all-gathered table, "
                     f"kz 64 and 16, {r['calls']} calls of one step)",
                route="cuda", source=f"{csrc}/{src_file}",
                replaces=f"{repo}/ops/flash_gat.py:{line}",
                launches=h["launches_step"][kind], max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=None))
        d = h["dropout"]
        for kind, r in list(d["edge_kernels"].items()) + [("softmax", d["softmax"])]:
            kernels.append(dict(
                name=f"{SEG_KERNELS.get(kind, 'softmax_stats')} ({transport}; PEAGAT --parallel "
                     f"dp --mesh_mp 2 --dropout {DROPOUT}, rank 0 of 2 on one card: the "
                     f"composed route on the union graphs over the all-gathered table, "
                     f"{r['calls']} calls of one step)",
                route="cuda", source=f"{csrc}/segment.cu",
                replaces=f"{repo}/ops/pallas_segment.py:{lines[kind]}",
                launches=d["launches_step"][kind], max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"]))
    stream_lines = {"stream_fwd": "220", "stream_bwd_dst": "292", "stream_bwd_src": "364"}
    for key, r in r0["b"]["f32"]["stream_kernels"].items():
        kind, transport = key.split("|")
        kernels.append(dict(
            name=f"{kind.replace('stream_', 'stream_gat_')} ({transport}; ML-25M --parallel "
                 "edge, rank 0 of 2 on one card: its shards, the step's channel groups)",
            route="cuda", source=f"{csrc}/stream_gat.cu",
            replaces=f"{repo}/ops/stream_gat.py:{stream_lines[kind]}",
            launches=r0["b"][transport]["launches_step"][kind], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
