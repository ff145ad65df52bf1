"""Unified CLI of the port: one entry point for every model of the JAX
package, the PEA models, the graph baselines and the walk models.

Port of the JAX package's ``cli.py`` with the same flags, defaults and
choices, plus ``--device`` (default: the card; ``cpu`` runs the kernels'
plain versions).  Defaults reproduce the published recipes
(experiments/scripts/*.ps1): ml-small = 5 runs x 30 epochs, bs 1024,
'unseen' sampling.

    python -m graph_recsys_benchmark_tpu_torch --model PEAGAT --dataset synthetic-ml \\
        --entity_aware true
    python -m graph_recsys_benchmark_tpu_torch --model PEAGCN --dataset ml-latest-small \\
        --raw_dir /data/ml-latest-small --entity_aware true --device cpu

Ported: PEAGCN, PEAGAT and PEASage on all six datasets (``ml-latest-small``,
``ml-25m`` and ``yelp`` read raw files under ``--raw_dir``; for the two
MovieLens sets ``--dataset_url file:///.../x.zip`` extracts a local
archive there first, data/download.py), both candidate modes (ML-25M defaults to rejection), f32 or
bf16 message transport (``--message_dtype``, the trainer's ``transport``),
GAT attention dropout (``--dropout``), Adam, SparseAdam or SGD; the
baselines NGCF, KGAT, KGCN, CFKG and NFM (train/baseline_trainers.py; NFM's
dropout defaults to 0.3, as in the JAX CLI); the walk models MetaPath2Vec
and HeRec (train/walk_trainers.py), which read the walk flags and keep
their stage-1 embeddings under ``<out_dir>/<hin>/<model>``.
``--parallel edge``, ``dp`` and ``a2a`` train PEAGCN, PEAGAT and PEASage
(parallel/engine.ShardedPEATrainer), ``edge`` also KGAT and KGCN
(make_sharded_kg_trainer), over the ranks of a torch.distributed world:
one process a rank, started with ``--dist_coordinator host:port
--dist_nprocs N --dist_rank r`` (or the GRB_* environment, or torchrun's),
the runtime begun before anything touches the card
(parallel/multihost.initialize_runtime: NCCL when each rank has a card of
its own, gloo when ranks share one or run on the CPU).  ``dp`` row-shards
the table over ``--mesh_mp`` ranks (default 2 on an even world, else 1),
``a2a`` over every rank; a mesh the world cannot hold raises ValueError
before any file is written.

Differences from the JAX CLI: nothing is fetched over the network (an
http(s) ``--dataset_url`` raises NotImplementedError, and without one the
grouplens default is only quoted when raw files are missing); the HIN
cache's file names carry the
package's name, so the port never unpickles a JAX ``HINData`` (which would
import the JAX package), even in the JAX CLI's cache directory; the run
directory's hash leaves out ``--runs``, so a later call with more runs
resumes the runs already done (run r's seed is 2019 + r whatever the
count), and leaves out the ``--dist_*`` flags, so the ranks of a world share
one run directory (rank 0 writes its files; utils/checkpoint.py,
utils/logging.py) and a later world resumes there on any port.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle

import numpy as np

PACKAGE = "graph_recsys_benchmark_tpu_torch"
BASELINE_MODELS = ("NGCF", "KGAT", "KGCN", "CFKG", "NFM")
WALK_MODELS = ("MetaPath2Vec", "HeRec")
PORTED_DATASETS = ("synthetic-ml", "synthetic-ml25m", "synthetic-yelp",
                   "ml-latest-small", "ml-25m", "yelp")
DIST_FLAGS = ("dist_coordinator", "dist_nprocs", "dist_rank")


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
                   help="a file:// URL of the dataset's archive (ml-latest-small, "
                        "ml-25m), extracted into --raw_dir when its files are missing; "
                        "the port fetches nothing over the network")
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
    # multi-process runtime (parallel/multihost.py): one process a rank;
    # also read from the GRB_* or torchrun environment when the flags are
    # absent
    p.add_argument("--dist_coordinator", default=None,
                   help="host:port (or a tcp:// / file:// URL) of the world's store")
    p.add_argument("--dist_nprocs", type=int, default=None)
    p.add_argument("--dist_rank", type=int, default=None)
    p.add_argument("--parallel", default="none",
                   choices=["none", "dp", "edge", "a2a"],
                   help="sharded training over the world's ranks: 'edge' (PEA models, "
                        "KGAT, KGCN) shards the edges and the batch; 'dp' (PEA) the batch "
                        "and the table over --mesh_mp; 'a2a' (PEA) the table, the "
                        "aggregates and the batch, with all-to-all lookups")
    p.add_argument("--mesh_mp", type=int, default=None,
                   help="--parallel dp's model axis: the ranks the table is row-sharded "
                        "over (default 2 on an even world, else 1)")
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


def _bool(s):
    return str(s).lower() == "true"


def _dataset_defaults(name):
    if name in ("ml-25m", "synthetic-ml25m"):
        return dict(runs=5, epochs=30, batch_size=4096, sampling="random")
    if name in ("yelp", "synthetic-yelp"):
        return dict(runs=3, epochs=20, batch_size=1024, sampling="random")
    return dict(runs=5, epochs=30, batch_size=1024, sampling="unseen")


def load_hin(args):
    """Build (or load cached) HINData + metapath edge list for the dataset,
    the table picked by the HIN's name as the JAX CLI does: Yelp's 11,
    ML-25M's 13, ml-small's 9.  The cache's file name hashes the dataset
    arguments under the package's name, so no JAX package pickle is ever
    read here."""
    from .data import movielens as ML
    from .data import yelp as Y

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
        tmp = f"{cache}.tmp{os.getpid()}"  # the ranks of a world may build it together
        with open(tmp, "wb") as f:
            pickle.dump(hin, f, protocol=4)
        os.replace(tmp, cache)
    if hin.name.startswith("yelp"):
        return hin, Y.yelp_metapath_edges(hin)
    if "25m" in hin.name:
        return hin, ML.ml25m_metapath_edges(hin)
    return hin, ML.mlsmall_metapath_edges(hin)


def _require_raw_files(args, required_files, default_url=None):
    """The raw files must be on disk under --raw_dir; the message of a
    missing one names --dataset_url's archive, or the dataset's default
    archive (`default_url`), which the port does not fetch."""
    if args.raw_dir is None:
        raise FileNotFoundError(
            f"--dataset {args.dataset} reads raw files: pass --raw_dir, the directory "
            f"that directly contains {list(required_files)}")
    missing = [f for f in required_files if not os.path.exists(os.path.join(args.raw_dir, f))]
    if missing:
        if args.dataset_url:
            hint = f" after extracting {args.dataset_url}"
        elif default_url:
            name = default_url.rpartition("/")[2]
            hint = (f"; the port fetches nothing over the network: get {default_url} "
                    f"and pass --dataset_url file:///path/to/{name}")
        else:
            hint = ""
        raise FileNotFoundError(
            f"raw dataset files missing under {args.raw_dir!r}{hint}: {missing}. Point "
            "--raw_dir at the directory that directly contains these files.")


def _maybe_download(args, required_files):
    """The JAX CLI's ``_maybe_download`` (cli.py:138-165) for a local
    archive: with --dataset_url and the raw files missing under --raw_dir,
    extract the archive there (data/download.ensure_raw_dataset; a URL other
    than file:// raises NotImplementedError before any connection); then
    the files must be there.  Without --dataset_url nothing is fetched: the
    JAX CLI would download the grouplens default, which the message
    quotes."""
    from .data.download import DATASET_URLS, ensure_raw_dataset

    if args.raw_dir is not None and args.dataset_url:
        ensure_raw_dataset(args.raw_dir, required_files, args.dataset_url)
    _require_raw_files(args, required_files, DATASET_URLS.get(args.dataset))


def _build_hin(args):
    """The dataset's HINData, with the JAX CLI's clamps and candidate modes
    (``--candidate_mode`` else dense, rejection for ML-25M)."""
    from .data import movielens as ML
    from .data import synthetic as S
    from .data import yelp as Y

    nc, nfc = args.num_core, args.num_feat_core
    cm = getattr(args, "candidate_mode", None)

    def _cm(default):
        return {"candidate_mode": cm or default}

    if args.dataset == "synthetic-ml":
        movies, ratings, tagging = S.synthetic_mlsmall_raw(seed=0)
        return ML.build_mlsmall_hin(
            movies, ratings, tagging, min(nc, 3), min(nfc, 2), **_cm("dense")
        )
    if args.dataset == "synthetic-ml25m":
        raw = S.synthetic_ml25m_raw(seed=0)
        return ML.build_ml25m_hin(*raw, min(nc, 3), min(nfc, 2), **_cm("rejection"))
    if args.dataset == "synthetic-yelp":
        b, u, rt = S.synthetic_yelp_raw(seed=0)
        return Y.build_yelp_hin(b, u, rt, num_core=4, **_cm("dense"))
    if args.dataset == "ml-latest-small":
        from .data.ml_raw import ML_FILES, parse_ml_dir

        _maybe_download(args, ML_FILES)
        movies, ratings, tagging = parse_ml_dir(args.raw_dir)
        return ML.build_mlsmall_hin(
            movies, ratings, tagging, nc, nfc, name="ml-latest-small", **_cm("dense")
        )
    if args.dataset == "ml-25m":
        from .data.ml_raw import ML25M_FILES, parse_ml25m_extras, parse_ml_dir

        _maybe_download(args, ML25M_FILES)
        movies, ratings, tagging = parse_ml_dir(args.raw_dir)
        gs, gt = parse_ml25m_extras(args.raw_dir)
        return ML.build_ml25m_hin(movies, ratings, tagging, gs, gt, nc, nfc,
                                  **_cm("rejection"))
    if args.dataset == "yelp":
        from .data.yelp_raw import YELP_FILES, parse_yelp_dir, preprocess_yelp_raw

        _require_raw_files(args, YELP_FILES)
        b, u, rv, tp, ck = parse_yelp_dir(args.raw_dir)
        b2, u2, rt = preprocess_yelp_raw(b, u, rv, tp, ck)
        return Y.build_yelp_hin(b2, u2, rt, num_core=nc, **_cm("dense"))
    raise ValueError(args.dataset)


def build_trainer(args, hin, mp_edges, mesh=None):
    """(the model's trainer on args.device, number of metapaths), as the JAX
    CLI builds them (cli.py:242-358); the baselines and the walk models have
    no metapaths to ablate."""
    from .train.pea_trainer import TrainConfig

    if args.parallel != "none":
        pea_ok = args.model in ("PEAGCN", "PEAGAT", "PEASage")
        kg_ok = args.model in ("KGAT", "KGCN") and args.parallel == "edge"
        if not (pea_ok or kg_ok):
            raise SystemExit(
                f"--parallel {args.parallel} supports the PEA family (dp/edge/a2a) and "
                f"KGAT/KGCN (edge); {args.model} runs single-device (omit --parallel)")
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
    if args.model in BASELINE_MODELS:
        return _build_baseline(args, hin, tcfg, mesh), 0
    if args.model in WALK_MODELS:
        return _build_walk(args, hin, tcfg), 0
    from .models.pea import PEAConfig
    from .train.pea_trainer import PEATrainer

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
    if args.parallel != "none":
        from .parallel.engine import ShardedPEATrainer

        return ShardedPEATrainer(hin, cfg, tcfg, metapath_edges=mp_edges,
                                 mesh=mesh or parallel_mesh(args), mode=args.parallel,
                                 transport=args.message_dtype), len(mp_edges)
    trainer = PEATrainer(hin, cfg, tcfg, metapath_edges=mp_edges, device=args.device,
                         transport=args.message_dtype)
    return trainer, len(mp_edges)


def _build_baseline(args, hin, tcfg, mesh=None):
    """NGCF, KGAT/KGCN (f32 or bf16 message transport), CFKG or NFM."""
    from .train import baseline_trainers as B

    model, device = args.model, args.device
    if model == "NGCF":
        from .models.ngcf import NGCFConfig

        cfg = NGCFConfig(
            num_nodes=hin.num_nodes, emb_dim=args.emb_dim,
            hidden_size=args.hidden_size, dropout=args.dropout,
            entity_aware=_bool(args.entity_aware),
            entity_aware_coff=args.entity_aware_coff,
        )
        return B.NGCFTrainer(hin, cfg, tcfg, device=device, transport=args.message_dtype)
    if model in ("KGAT", "KGCN"):
        from .models.kg import KGConfig

        cfg = KGConfig(
            variant=model.lower(), num_nodes=hin.num_nodes,
            num_relations=hin.num_edge_types, emb_dim=args.emb_dim,
            hidden_size=args.hidden_size, dropout=args.dropout,
        )
        if args.parallel == "edge":
            from .parallel.engine import make_sharded_kg_trainer

            return make_sharded_kg_trainer(hin, cfg, tcfg, mesh or parallel_mesh(args),
                                           transport=args.message_dtype)
        return B.KGTrainer(hin, cfg, tcfg, device=device, transport=args.message_dtype)
    if model == "CFKG":
        from .models.cfkg import CFKGConfig

        cfg = CFKGConfig(
            num_nodes=hin.num_nodes, num_relations=hin.num_edge_types,
            user2item_rel=hin.edge_type_dict["user2item"], emb_dim=args.emb_dim,
        )
        return B.CFKGTrainer(hin, cfg, tcfg, device=device)
    from .models.nfm import NFMConfig

    cfg = NFMConfig(
        num_users=hin.num_users, num_items=hin.num_items,
        emb_dim=args.emb_dim, hidden_size=args.hidden_size,
        dropout=args.dropout if args.dropout else 0.3,
    )
    return B.NFMTrainer(hin, cfg, tcfg, device=device)


def _build_walk(args, hin, tcfg):
    """MetaPath2Vec or HeRec with the walk flags, as JAX cli.py:320-358: walks
    start at the users, but MetaPath2Vec's on Yelp at item_reviewcount
    (its metapath's start type); the stage-1 cache is one level above the
    hashed run directories, like the reference's random_walk_*.pkl
    (metapath2vec_solver_bpr.py:197)."""
    from .data.yelp import YELP_HEREC_METAPATHS, YELP_MP2V_STEPS
    from .models.metapath2vec import MP2VConfig
    from .train import walk_trainers as W

    yelp = hin.name.startswith("yelp")
    start = "item_reviewcount" if yelp and args.model == "MetaPath2Vec" else hin.types[0]
    cfg = MP2VConfig(
        embedding_dim=args.emb_dim, walk_length=args.walk_length,
        context_size=args.context_size, walks_per_node=args.walks_per_node,
        num_negative_samples=args.rw_negative_samples,
        start_offset=hin.type_accs[start], num_start=hin.num_nodes_dict[start],
        num_nodes=hin.num_nodes,
    )
    cache = os.path.join(args.out_dir, hin.name, args.model)
    if args.model == "MetaPath2Vec":
        steps = YELP_MP2V_STEPS if yelp else W.ML_MP2V_STEPS
        return W.MetaPath2VecTrainer(hin, cfg, tcfg, relation_steps=steps, cache_dir=cache,
                                     device=args.device)
    metapaths = YELP_HEREC_METAPATHS if yelp else W.ML_HEREC_METAPATHS
    return W.HeRecTrainer(hin, cfg, tcfg, metapaths=metapaths, cache_dir=cache,
                          device=args.device)


def run_dir(args, hin):
    """<out_dir>/<hin>/<model>/<hash of the arguments but --runs and the
    --dist_* flags>: every rank of a world, and a later world, find the
    same directory."""
    key = {k: v for k, v in vars(args).items() if k != "runs" and k not in DIST_FLAGS}
    return os.path.join(
        args.out_dir, hin.name, args.model,
        hashlib.sha1(json.dumps(key, sort_keys=True, default=str).encode()).hexdigest()[:12],
    )


def parallel_mesh(args):
    """The mesh of --parallel (the world; 'dp' over mp = --mesh_mp or 2 on
    an even world, else 1, JAX cli.py:255-266), or None without it."""
    if args.parallel == "none":
        return None
    from .parallel.engine import default_mesh

    return default_mesh(args.parallel, args.mesh_mp, device=args.device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    # before anything touches the card
    from .parallel.multihost import initialize_runtime

    initialize_runtime(args.dist_coordinator, args.dist_nprocs, args.dist_rank,
                       device=args.device)
    mesh = parallel_mesh(args)  # a mesh the world cannot hold raises before any file
    hin, mp_edges = load_hin(args)
    print(
        f"{hin.name}: {hin.num_nodes} nodes ({hin.num_users} users, "
        f"{hin.num_items} items), {hin.train_pos.shape[0]} train interactions"
    )
    trainer, num_metapaths = build_trainer(args, hin, mp_edges, mesh)

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
