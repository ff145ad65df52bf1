#!/usr/bin/env python3
"""One MetaPath2Vec pretraining batch's skip-gram loss and backward on the
card, its rows gathered two ways in turns on the same walks and weights:

    python3 torch_tools/walk_backward.py

* ``F.embedding`` (models/metapath2vec._window_loss, the port's way): its
  backward sorts the indices and sums each row's repeats in parallel
  pieces;
* indexing (``emb[idx]``), whose backward (``index_put_`` with
  accumulate) adds one index's repeats one after another.

On chip_smoke.flagship_hin() at the CLI's walk defaults
(chip_smoke.walk_config: emb 64, walk length 100, context 7, 1,000 walks a
node, 5 negatives) for the 8 starts of one batch, on ML_MP2V_STEPS (14
genre nodes that every walk crosses) and the user-item metapath: the loss
of both, each gradient against the other, and the ms of loss + backward
(host clock with synchronize), four a way in turns.  Prints the card's
name and power limit first.  Needs a CUDA device (exit 2 without one).
"""

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def indexed_window_loss(emb, rw, cfg, positive):
    """models/metapath2vec._window_loss with the rows gathered by indexing."""
    import torch
    import torch.nn.functional as F

    num_windows = cfg.walk_length + 2 - cfg.context_size
    h_start = emb[rw[:, :num_windows]]
    total = 0.0
    for k in range(1, cfg.context_size):
        dots = torch.sum(h_start * emb[rw[:, k:k + num_windows]], dim=-1)
        total = total + torch.sum(F.softplus(-dots if positive else dots))
    return total / (rw.shape[0] * num_windows * (cfg.context_size - 1))


def main():
    import torch

    if not torch.cuda.is_available():
        print("walk_backward: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from graph_recsys_benchmark_tpu_torch.models import metapath2vec as M
    from graph_recsys_benchmark_tpu_torch.train.walk_trainers import ML_HEREC_METAPATHS, RW_BATCH

    hin = cs.flagship_hin()
    cfg = cs.walk_config(hin, "uid")
    ways = {"F.embedding": lambda e, rw, p: M._window_loss(e, rw, cfg, p),
            "indexing": lambda e, rw, p: indexed_window_loss(e, rw, cfg, p)}
    for name, steps in zip(("ML_MP2V_STEPS", "user-item"), ML_HEREC_METAPATHS):
        csr = M.metapath_from_hin(hin, steps, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(9)
        starts = torch.arange(RW_BATCH, device="cuda")
        pos = M.sample_pos_walks(gen, starts, csr, cfg)
        neg = M.sample_neg_walks(gen, starts, csr, cfg)
        emb = torch.randn((hin.num_nodes, cfg.embedding_dim), device="cuda",
                          requires_grad=True)

        def run(way):
            emb.grad = None
            loss = ways[way](emb, pos, True) + ways[way](emb, neg, False)
            loss.backward()
            return float(loss.detach()), emb.grad.clone()

        (a, ga), (b, gb) = run("F.embedding"), run("indexing")
        rel = float((ga - gb).abs().max() / gb.abs().max())
        times = {w: [] for w in ways}
        for order in (("indexing", "F.embedding"), ("F.embedding", "indexing")) * 2:
            for way in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(way)
                torch.cuda.synchronize()
                times[way].append((time.perf_counter() - t0) * 1e3)
        print(f"{name}: loss F.embedding {a:.6f} indexing {b:.6f}; gradients apart by "
              f"{rel:.3e} of the largest; loss + backward ms a batch (in turns) "
              + "; ".join(f"{w} {[round(t, 2) for t in ts]}" for w, ts in times.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
