"""Unified CLI of the port: one entry point for the PEA models.

Port of the JAX package's ``cli.py`` with the same flags, defaults and
choices, plus ``--device`` (default: the card; ``cpu`` runs the kernels'
plain versions).  Defaults reproduce the published recipes
(experiments/scripts/*.ps1): ml-small = 5 runs x 30 epochs, bs 1024,
'unseen' sampling.

    python -m graph_recsys_benchmark_tpu_torch --model PEAGAT --dataset synthetic-ml \\
        --entity_aware true
    python -m graph_recsys_benchmark_tpu_torch --model PEAGCN --dataset ml-latest-small \\
        --raw_dir /data/ml-latest-small --entity_aware true --device cpu

Ported: PEAGCN, PEAGAT and PEASage on ``synthetic-ml`` and
``ml-latest-small`` (raw files already on disk: nothing is downloaded),
both candidate modes, f32 or bf16 message transport (``--message_dtype``,
the trainer's ``transport``), Adam or SGD.  The other choices raise
``NotImplementedError`` before any work, naming the ROADMAP Queue 1 item
that ports them.

Differences from the JAX CLI: the HIN cache's file names carry the
package's name, so the port never unpickles a JAX ``HINData`` (which would
import the JAX package), even in the JAX CLI's cache directory; the run
directory's hash leaves out ``--runs``, so a later call with more runs
resumes the runs already done (run r's seed is 2019 + r whatever the
count).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle

import numpy as np

PACKAGE = "graph_recsys_benchmark_tpu_torch"
PEA_MODELS = ("PEAGCN", "PEAGAT", "PEASage")
PORTED_DATASETS = ("synthetic-ml", "ml-latest-small")
# ROADMAP Queue 1 items by title
DATASETS_ITEM = 'ROADMAP Queue 1, "The remaining datasets"'
BASELINES_ITEM = 'ROADMAP Queue 1, "Baselines"'
OPTIONS_ITEM = 'ROADMAP Queue 1, "Training options left out of slice 2"'
PARALLEL_ITEM = 'ROADMAP Queue 1, "Parallel, last"'


def build_parser():
    p = argparse.ArgumentParser(PACKAGE)
    p.add_argument("--model", default="PEAGCN",
                   choices=["PEAGCN", "PEAGAT", "PEASage", "NGCF", "KGAT", "KGCN",
                            "CFKG", "NFM", "MetaPath2Vec", "HeRec"])
    p.add_argument("--dataset", default="synthetic-ml",
                   choices=["synthetic-ml", "synthetic-ml25m", "synthetic-yelp",
                            "ml-latest-small", "ml-25m", "yelp"])
    p.add_argument("--raw_dir", default=None, help="raw data directory for real datasets")
    p.add_argument("--dataset_url", default=None,
                   help="archive URL of the JAX CLI's auto-download; the port "
                        "downloads nothing and only names it when files are missing")
    p.add_argument("--out_dir", default="runs")
    p.add_argument("--num_core", type=int, default=10)
    p.add_argument("--num_feat_core", type=int, default=10)
    p.add_argument("--candidate_mode", default=None, choices=[None, "dense", "rejection"],
                   help="negative-candidate structure: 'dense' padded unseen tables "
                        "(O(U*I)) or 'rejection' seen tables (O(U*K), ml-25m default)")
    p.add_argument("--entity_aware", default="false")
    p.add_argument("--entity_aware_coff", type=float, default=0.1)
    p.add_argument("--emb_dim", type=int, default=64)
    p.add_argument("--hidden_size", type=int, default=64)
    p.add_argument("--repr_dim", type=int, default=16)
    p.add_argument("--num_heads", type=int, default=1)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--channel_aggr", default="att")
    p.add_argument("--runs", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-3)
    p.add_argument("--opt", default="adam")
    p.add_argument("--num_negative_samples", type=int, default=4)
    p.add_argument("--num_neg_candidates", type=int, default=99)
    p.add_argument("--sampling_strategy", default=None)
    p.add_argument("--init_eval", default="true")
    p.add_argument("--full_ranking", default="false",
                   help="also report full-catalog ranking HR/NDCG at the end "
                        "of each run (north-star extension of the "
                        "99-negative protocol)")
    p.add_argument("--metapath_test", default="false")
    p.add_argument("--save_every_epoch", type=int, default=26)
    p.add_argument("--cache_dir", default=".hin_cache")
    p.add_argument(
        "--message_dtype", default="f32", choices=("f32", "bf16"),
        help="edge message-transport dtype (the trainer's transport): bf16 "
        "halves the edge kernels' traffic (f32 accumulation)",
    )
    # multi-host runtime of the JAX CLI; not ported
    p.add_argument("--dist_coordinator", default=None)
    p.add_argument("--dist_nprocs", type=int, default=None)
    p.add_argument("--dist_rank", type=int, default=None)
    p.add_argument("--parallel", default="none",
                   choices=["none", "dp", "edge", "a2a"],
                   help="mesh-sharded training for PEA models (only 'none' is ported)")
    p.add_argument("--mesh_mp", type=int, default=None)
    # walk-stage params (metapath2vec_solver_bpr.py:36-58), read by the walk models
    p.add_argument("--walk_length", type=int, default=100)
    p.add_argument("--context_size", type=int, default=7)
    p.add_argument("--walks_per_node", type=int, default=1000)
    p.add_argument("--rw_negative_samples", type=int, default=5)
    # the port's own
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                        "kernels' plain versions)")
    return p


_WALK_FLAGS = ("walk_length", "context_size", "walks_per_node", "rw_negative_samples")


def _bool(s):
    return str(s).lower() == "true"


def _dataset_defaults(name):
    if name in ("ml-25m", "synthetic-ml25m"):
        return dict(runs=5, epochs=30, batch_size=4096, sampling="random")
    if name in ("yelp", "synthetic-yelp"):
        return dict(runs=3, epochs=20, batch_size=1024, sampling="random")
    return dict(runs=5, epochs=30, batch_size=1024, sampling="unseen")


def check_ported(args):
    """NotImplementedError for every choice the port does not run yet,
    naming the ROADMAP Queue 1 item that ports it."""
    defaults = build_parser().parse_args([])
    if args.dataset not in PORTED_DATASETS:
        raise NotImplementedError(
            f"--dataset {args.dataset} is not ported (ported: "
            f"{', '.join(PORTED_DATASETS)}): {DATASETS_ITEM}")
    if args.model not in PEA_MODELS:
        raise NotImplementedError(
            f"--model {args.model} is not ported (ported: {', '.join(PEA_MODELS)}): "
            f"{BASELINES_ITEM}")
    changed = [f for f in _WALK_FLAGS if getattr(args, f) != getattr(defaults, f)]
    if changed:
        raise NotImplementedError(
            f"--{', --'.join(changed)}: read by the walk models only, which are not "
            f"ported: {BASELINES_ITEM}")
    if args.dropout > 0:
        raise NotImplementedError(f"--dropout {args.dropout}: attention dropout is not "
                                  f"ported: {OPTIONS_ITEM}")
    if args.opt.lower() == "sparseadam":
        raise NotImplementedError(f"--opt sparseadam is not ported: {OPTIONS_ITEM}")
    dist = [f"--{f}" for f in ("dist_coordinator", "dist_nprocs", "dist_rank", "mesh_mp")
            if getattr(args, f) is not None]
    if args.parallel != "none" or dist:
        what = " ".join(([f"--parallel {args.parallel}"] if args.parallel != "none" else [])
                        + dist)
        raise NotImplementedError(f"{what}: the parallel layer is not ported: "
                                  f"{PARALLEL_ITEM}")


def load_hin(args):
    """Build (or load cached) HINData + metapath edge list for the dataset.
    The cache's file name hashes the dataset arguments under the package's
    name, so no JAX package pickle is ever read here."""
    from .data import movielens as ML

    key = json.dumps(
        [PACKAGE, args.dataset, args.raw_dir, args.num_core, args.num_feat_core,
         getattr(args, "candidate_mode", None)],
        sort_keys=True,
    )
    os.makedirs(args.cache_dir, exist_ok=True)
    cache = os.path.join(
        args.cache_dir,
        f"{PACKAGE}-{hashlib.sha1(key.encode()).hexdigest()[:16]}.pkl",
    )
    if os.path.isfile(cache):
        with open(cache, "rb") as f:
            hin = pickle.load(f)
    else:
        hin = _build_hin(args)
        with open(cache, "wb") as f:
            pickle.dump(hin, f, protocol=4)
    return hin, ML.mlsmall_metapath_edges(hin)


def _require_raw_files(args, required_files):
    """The raw files must be on disk: the port downloads nothing."""
    if args.raw_dir is None:
        raise FileNotFoundError(
            f"--dataset {args.dataset} reads raw files: pass --raw_dir, the directory "
            f"that directly contains {list(required_files)}")
    missing = [f for f in required_files if not os.path.exists(os.path.join(args.raw_dir, f))]
    if missing:
        url = f" (for example, extracted from {args.dataset_url})" if args.dataset_url else ""
        raise FileNotFoundError(
            f"raw dataset files missing under {args.raw_dir!r}: {missing}. The port "
            f"downloads nothing: put the files there{url}, or point --raw_dir at the "
            "directory that directly contains them.")


def _build_hin(args):
    from .data import movielens as ML
    from .data import synthetic as S

    nc, nfc = args.num_core, args.num_feat_core
    cm = getattr(args, "candidate_mode", None) or "dense"

    if args.dataset == "synthetic-ml":
        movies, ratings, tagging = S.synthetic_mlsmall_raw(seed=0)
        return ML.build_mlsmall_hin(
            movies, ratings, tagging, min(nc, 3), min(nfc, 2), candidate_mode=cm
        )
    if args.dataset == "ml-latest-small":
        from .data.ml_raw import ML_FILES, parse_ml_dir

        _require_raw_files(args, ML_FILES)
        movies, ratings, tagging = parse_ml_dir(args.raw_dir)
        return ML.build_mlsmall_hin(
            movies, ratings, tagging, nc, nfc, name="ml-latest-small", candidate_mode=cm
        )
    raise NotImplementedError(f"--dataset {args.dataset} is not ported: {DATASETS_ITEM}")


def build_trainer(args, hin, mp_edges):
    """(PEATrainer on args.device, number of metapaths)."""
    from .models.pea import PEAConfig
    from .train.pea_trainer import PEATrainer, TrainConfig

    check_ported(args)
    defaults = _dataset_defaults(args.dataset)
    tcfg = TrainConfig(
        batch_size=args.batch_size or defaults["batch_size"],
        lr=args.lr,
        weight_decay=args.weight_decay,
        opt=args.opt,
        num_negative_samples=args.num_negative_samples,
        num_neg_candidates=args.num_neg_candidates,
        sampling_strategy=args.sampling_strategy or defaults["sampling"],
        epochs=args.epochs or defaults["epochs"],
        runs=args.runs or defaults["runs"],
    )
    conv = {"PEAGCN": "gcn", "PEAGAT": "gat", "PEASage": "sage"}[args.model]
    cfg = PEAConfig(
        conv=conv, num_nodes=hin.num_nodes,
        meta_path_steps=(2,) * len(mp_edges),
        emb_dim=args.emb_dim, hidden_size=args.hidden_size,
        repr_dim=args.repr_dim, num_heads=args.num_heads,
        channel_aggr=args.channel_aggr, dropout=args.dropout,
        entity_aware=_bool(args.entity_aware),
        entity_aware_coff=args.entity_aware_coff,
    )
    trainer = PEATrainer(hin, cfg, tcfg, metapath_edges=mp_edges, device=args.device,
                         transport=args.message_dtype)
    return trainer, len(mp_edges)


def run_dir(args, hin):
    """<out_dir>/<hin>/<model>/<hash of the arguments but --runs>."""
    key = {k: v for k, v in vars(args).items() if k != "runs"}
    return os.path.join(
        args.out_dir, hin.name, args.model,
        hashlib.sha1(json.dumps(key, sort_keys=True, default=str).encode()).hexdigest()[:12],
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_ported(args)
    hin, mp_edges = load_hin(args)
    print(
        f"{hin.name}: {hin.num_nodes} nodes ({hin.num_users} users, "
        f"{hin.num_items} items), {hin.train_pos.shape[0]} train interactions"
    )
    trainer, num_metapaths = build_trainer(args, hin, mp_edges)

    from .train.solver import Solver

    solver = Solver(
        trainer,
        run_dir(args, hin),
        runs=trainer.tcfg.runs,
        epochs=trainer.tcfg.epochs,
        init_eval=_bool(args.init_eval),
        save_every_epoch=args.save_every_epoch,
        metapath_test=_bool(args.metapath_test),
        num_metapaths=num_metapaths,
        full_ranking=_bool(args.full_ranking),
    )
    overall = solver.run()
    if overall:
        print(
            "Overall HR@10: {:.4f}, NDCG@10: {:.4f}, AUC: {:.4f}".format(
                overall["HR"][5], overall["NDCG"][5],
                float(np.ravel(overall["AUC"])[0])
            )
        )
    return overall


if __name__ == "__main__":
    main()
