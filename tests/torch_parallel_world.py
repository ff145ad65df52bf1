"""Two-rank gloo worlds on the CPU for the port's parallel tests
(test_torch_parallel_pieces.py, test_torch_edge_parallel.py,
test_torch_multihost.py).

``World(tmp_path, tasks)`` (the parent side, stdlib and numpy only)
starts two processes of this file, each a rank of one world over a
``file://`` store in `tmp_path`, which run every task of `tasks`;
``result()`` waits for them and returns {task: [rank 0's result, rank 1's
result]}, each a dict of numpy arrays (``np.load`` of the rank's
``.npz``).  A task reads its inputs from ``<tmp_path>/<task>.in.npz`` when
the parent wrote one.

The children pin torch to one thread and import torch and the port only
(never jax, never a test module); ``TASKS`` below is what they run.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 240

# the HINs of the JAX package's own parallel tests
EDGE_RAW = dict(seed=3, num_users=50, num_items=40, min_ratings_per_user=5,
                max_ratings_per_user=10)
EDGE_CORE = dict(num_core=2, num_feat_core=1)
STREAM_RAW = dict(seed=7, num_users=60, num_items=90, min_ratings_per_user=12,
                  max_ratings_per_user=30, num_directors=20, num_actors=40, num_writers=25,
                  num_tags=30, tagging_rows=200)
STREAM_CORE = dict(num_core=3, num_feat_core=2)
WIDTHS = dict(emb_dim=16, hidden_size=16, repr_dim=8)
N_CHAN = 4  # the JAX test_stream_edge_sharded.py's cut


class World:
    """A running world of `nprocs` CPU ranks over `tasks` ({name: kwargs});
    ``result()`` waits for it -> {name: [per-rank dict of numpy arrays]}.
    The parent computes its references meanwhile.  A rank's failure raises
    with every rank's output."""

    def __init__(self, tmp_path, tasks, nprocs=2):
        self.tmp, self.tasks, self.nprocs = str(tmp_path), tasks, nprocs
        spec = os.path.join(self.tmp, "world.json")
        with open(spec, "w") as f:
            json.dump({"store": f"file://{os.path.join(self.tmp, 'store')}", "dir": self.tmp,
                       "nprocs": nprocs, "tasks": tasks}, f)
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), spec,
                                        str(r)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True, env=env,
                                       cwd=self.tmp)
                      for r in range(nprocs)]

    def result(self, timeout=WORLD_TIMEOUT_S):
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in self.procs):
            raise AssertionError("\n".join(f"--- rank {r} (exit {p.returncode}):\n{o}"
                                           for r, (p, o) in enumerate(zip(self.procs, outs))))
        res = {}
        for name in self.tasks:
            res[name] = []
            for r in range(self.nprocs):
                with np.load(os.path.join(self.tmp, f"{name}.{r}.npz")) as z:
                    res[name].append({k: z[k] for k in z.files})
        return res


def run_world(tmp_path, tasks, nprocs=2):
    """World(tmp_path, tasks, nprocs).result()."""
    return World(tmp_path, tasks, nprocs).result()


# ---------------------------------------------------------------- the ranks


@functools.lru_cache(maxsize=None)
def _edge_hin():
    from graph_recsys_benchmark_tpu_torch.data import movielens as tml
    from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn

    return tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(**EDGE_RAW), **EDGE_CORE)


@functools.lru_cache(maxsize=None)
def _stream_hin():
    from graph_recsys_benchmark_tpu_torch.data import movielens as tml
    from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn

    return tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(**STREAM_RAW), **STREAM_CORE)


def grad_tree(params):
    """The .grad of every parameter in the JAX pytree layout
    (models/params.to_numpy)."""
    import copy

    from graph_recsys_benchmark_tpu_torch.models.params import to_numpy

    g = copy.deepcopy(params)
    for p, q in zip(g.parameters(), params.parameters()):
        p.data = q.grad.detach().clone()
    return to_numpy(g)


def flat(prefix, tree):
    """{prefix/name: array} of a to_numpy tree or a grads dict."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(f"{prefix}/{k}", v))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(flat(f"{prefix}/{i}", v))
    else:
        out[prefix] = np.asarray(tree)
    return out


def task_collectives(mesh, inp):
    """psum's forward and gradient, pmax, all_reduce_grads."""
    import torch

    from graph_recsys_benchmark_tpu_torch.parallel.collectives import (
        all_reduce_grads,
        gather_digests,
        pmax,
        psum,
    )

    r = mesh.rank
    x = (torch.arange(6, dtype=torch.float32).reshape(2, 3) * (r + 1)).requires_grad_()
    y = psum(x, mesh)
    c = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10.0 * (r + 1)
    (y * c).sum().backward()
    m = pmax(x * (1 - 2 * r), mesh)
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(1.0)
        lin.bias.fill_(0.0)
    loss = lin(torch.full((1, 3), float(r + 1))).sum()
    loss.backward()
    total = all_reduce_grads(list(lin.parameters()), mesh, extra=loss.detach())
    digests = gather_digests(list(lin.parameters()), mesh)
    return {"y": y.detach().numpy(), "grad": x.grad.numpy(), "m": m.numpy(),
            "m_grad": np.asarray(m.requires_grad), "w_grad": lin.weight.grad.numpy(),
            "b_grad": lin.bias.grad.numpy(), "loss": total.numpy(),
            "digests_equal": np.asarray(len(set(digests)) == 1)}


def task_softmax_aggregate(mesh, inp):
    """make_sharded_softmax and make_psum_aggregate on the rank's shard of a
    small SAGE graph: outputs and the gradients of sum(out * ct_rank)."""
    import torch

    from graph_recsys_benchmark_tpu_torch.graph import build_sage_graph
    from graph_recsys_benchmark_tpu_torch.parallel.edge_parallel import (
        make_psum_aggregate,
        make_sharded_softmax,
        shard_step_graph,
    )

    n = int(inp["n"])
    g = shard_step_graph(build_sage_graph(inp["src"], inp["dst"], n), mesh.dp)[mesh.rank]
    r = mesh.rank
    alpha = torch.from_numpy(inp["alpha"][r]).requires_grad_()
    msgs = torch.from_numpy(inp["msgs"][r]).requires_grad_()
    sm = make_sharded_softmax(mesh)(alpha, g.dst, n)
    (sm * torch.from_numpy(inp["wt"][r])).sum().backward()
    agg = make_psum_aggregate(mesh)(msgs, g)
    (agg * torch.from_numpy(inp["ct"][r])).sum().backward()
    return {"sm": sm.detach().numpy(), "dalpha": alpha.grad.numpy(),
            "agg": agg.detach().numpy(), "dmsgs": msgs.grad.numpy()}


def task_stream(mesh, inp):
    """StreamGAT on the rank's shard of a gat_loops graph with psum_scale
    1/dp: out, and the gradients of sum(out * ct_rank) summed over the
    ranks."""
    import torch

    from graph_recsys_benchmark_tpu_torch.graph import build_gat_graph
    from graph_recsys_benchmark_tpu_torch.parallel.collectives import all_reduce_
    from graph_recsys_benchmark_tpu_torch.parallel.edge_parallel import shard_step_graph
    from graph_recsys_benchmark_tpu_torch.ops.stream_gat import stream_gat_attention_batched

    n = int(inp["n"])
    full = build_gat_graph(inp["src"], inp["dst"], n, analytic_loops=True)
    g = shard_step_graph(full, mesh.dp)[mesh.rank]
    z, a_s, a_d = (torch.from_numpy(inp[k]).requires_grad_() for k in ("z", "a_src", "a_dst"))
    out = stream_gat_attention_batched(z, a_s, a_d, g.src, g.dst, g.src_perm, g.src_sorted,
                                       n, True, 0.2, "f32", g.block_bounds,
                                       g.src_block_bounds, mesh=mesh,
                                       psum_scale=1.0 / mesh.dp)
    (out * torch.from_numpy(inp["ct"][mesh.rank])).sum().backward()
    res = {"out": out.detach().numpy()}
    for k, t in (("dz", z), ("da_src", a_s), ("da_dst", a_d)):
        res[k] = all_reduce_(t.grad.contiguous(), mesh).numpy()
    return res


def task_fused_step(mesh, inp, conv, entity_aware, adam=False):
    """The edge-sharded union step (4 channels) on the rank's rows of
    inp['batch']: the total loss and the all-reduced gradients (and, with
    `adam`, the parameters after one Adam step)."""
    import torch

    from graph_recsys_benchmark_tpu_torch.data import movielens as tml
    from graph_recsys_benchmark_tpu_torch.graph import build_fused_metapath_graphs
    from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig, pea_init
    from graph_recsys_benchmark_tpu_torch.models.params import to_numpy
    from graph_recsys_benchmark_tpu_torch.parallel.edge_parallel import (
        _local_view,
        make_edge_sharded_train_step,
        shard_fused_graphs,
        sharded_grads,
    )
    from graph_recsys_benchmark_tpu_torch.train.optim import make_optimizer

    hin = _edge_hin()
    edges = tml.mlsmall_metapath_edges(hin)[:N_CHAN]
    cfg = PEAConfig(conv=conv, num_nodes=hin.num_nodes, meta_path_steps=(2,) * N_CHAN,
                    entity_aware=bool(entity_aware), **WIDTHS)
    fused = build_fused_metapath_graphs(edges, hin.num_nodes, conv)
    local = tuple(_local_view(s, mesh) for s in shard_fused_graphs(fused, mesh.dp))
    params = pea_init(torch.Generator().manual_seed(0), cfg)
    step, place = make_edge_sharded_train_step(cfg, local, mesh)
    batch, mask = place(torch.from_numpy(inp["batch"]).long(), torch.from_numpy(inp["mask"]))
    loss = sharded_grads(step.local_loss, params, batch, mask, mesh)
    res = {"loss": loss.numpy(), **flat("grad", grad_tree(params))}
    if adam:
        opt = make_optimizer("adam", 1e-3, 1e-3)(params.parameters())
        opt.step()
        res.update(flat("param", to_numpy(params)))
    return res


def task_stream_step(mesh, inp):
    """The edge-sharded streaming step (4 channels, implicit self-loops on
    every graph) on the rank's rows: total loss, all-reduced gradients."""
    import torch

    from graph_recsys_benchmark_tpu_torch.data import movielens as tml
    from graph_recsys_benchmark_tpu_torch.graph import build_metapath_graphs
    from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig, pea_init
    from graph_recsys_benchmark_tpu_torch.parallel.edge_parallel import (
        _local_view,
        make_stream_edge_sharded_train_step,
        plan_channel_shards,
        sharded_grads,
    )

    hin = _stream_hin()
    cfg = PEAConfig(conv="gat", num_nodes=hin.num_nodes, meta_path_steps=(2,) * N_CHAN,
                    entity_aware=False, **WIDTHS)
    per_channel = build_metapath_graphs(tml.mlsmall_metapath_edges(hin)[:N_CHAN],
                                        hin.num_nodes, "gat", analytic_gat_loops=True)
    groups, dist = plan_channel_shards(per_channel, mesh.dp)
    local = tuple(tuple(_local_view(d, mesh) for d in step) for step in dist)
    params = pea_init(torch.Generator().manual_seed(0), cfg)
    step, place = make_stream_edge_sharded_train_step(cfg, groups, local, mesh)
    batch, mask = place(torch.from_numpy(inp["batch"]).long(), torch.from_numpy(inp["mask"]))
    loss = sharded_grads(step.local_loss, params, batch, mask, mesh)
    return {"loss": loss.numpy(), **flat("grad", grad_tree(params))}


# the trainers' world: the JAX tests/test_parallel_engine.py setup
TRAIN_RAW = dict(seed=0, num_users=56, num_items=44, min_ratings_per_user=6,
                 max_ratings_per_user=14, tagging_rows=150)
TRAIN_CORE = dict(num_core=2, num_feat_core=1)
TRAIN_TCFG = dict(batch_size=64, sampling_strategy="unseen", num_negative_samples=2,
                  num_neg_candidates=13)
TRAIN_SEED, EPOCH_SEED, EVAL_SEED = 2020, 5, 6


def trainers_setup(device="cpu", mesh=None, conv="gat"):
    """(PEA trainer, KG trainer) on the trainers' world: single-process
    ones, or with `mesh` the edge-sharded ones (PEAGAT, or `conv`,
    entity-aware, 9 channels, widths 16 / 16 / 8; KGAT at emb 16, hidden
    16)."""
    from graph_recsys_benchmark_tpu_torch.data import movielens as tml
    from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
    from graph_recsys_benchmark_tpu_torch.models.kg import KGConfig
    from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig
    from graph_recsys_benchmark_tpu_torch.parallel.engine import (
        ShardedPEATrainer,
        make_sharded_kg_trainer,
    )
    from graph_recsys_benchmark_tpu_torch.train.baseline_trainers import KGTrainer
    from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

    hin = tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(**TRAIN_RAW), **TRAIN_CORE)
    cfg = PEAConfig(conv=conv, num_nodes=hin.num_nodes, meta_path_steps=(2,) * 9,
                    entity_aware=True, **WIDTHS)
    kcfg = KGConfig(variant="kgat", num_nodes=hin.num_nodes,
                    num_relations=hin.num_edge_types, emb_dim=16, hidden_size=16)
    tcfg = TrainConfig(**TRAIN_TCFG)
    edges = tml.mlsmall_metapath_edges(hin)
    if mesh is None:
        return (PEATrainer(hin, cfg, tcfg, metapath_edges=edges, device=device),
                KGTrainer(hin, kcfg, tcfg, device=device))
    return (ShardedPEATrainer(hin, cfg, tcfg, metapath_edges=edges, mesh=mesh),
            make_sharded_kg_trainer(hin, kcfg, tcfg, mesh))


def train_and_eval(pea, kg):
    """One epoch of each trainer from TRAIN_SEED, then an eval of each -> a
    dict of numpy values, and the two trained modules."""
    import torch

    out = {}
    for name, tr in (("pea", pea), ("kg", kg)):
        params = tr.init(TRAIN_SEED)
        opt = tr.optimizer(params)
        loss = tr.run_epoch(params, opt, torch.Generator(device=tr.device).manual_seed(EPOCH_SEED))
        if isinstance(loss, dict):
            out[f"{name}/kg_train_loss"] = np.asarray(float(loss["kg_train_loss"]))
            loss = loss["train_loss"]
        out[f"{name}/train_loss"] = np.asarray(float(loss))
        m = tr.evaluate(params, torch.Generator(device=tr.device).manual_seed(EVAL_SEED))
        for k in ("HR", "NDCG", "AUC", "eval_loss"):
            out[f"{name}/{k}"] = np.asarray(m[k].cpu() if hasattr(m[k], "cpu") else m[k])
        out[f"{name}/params"] = params
    return out


def task_trainers(mesh, inp):
    """ShardedPEATrainer and the sharded KGAT trainer, one epoch each, from
    the same seeds as the single-process trainers, their evals, and whether
    every rank's parameters are bitwise the same after."""
    from graph_recsys_benchmark_tpu_torch.parallel.collectives import gather_digests

    pea, kg = trainers_setup(mesh=mesh)
    out = train_and_eval(pea, kg)
    for name in ("pea", "kg"):
        digests = gather_digests(list(out.pop(f"{name}/params").parameters()), mesh)
        out[f"{name}/digests_equal"] = np.asarray(len(set(digests)) == 1)
    out["pea/batch_size"] = np.asarray(pea.tcfg.batch_size)
    out["pea/edge_graphs"] = np.asarray(len(pea._edge_graphs))
    return out


def task_runtime(mesh, inp):
    """A second initialize_runtime is a no-op; the backend; only rank 0
    writes a checkpoint (each rank saves to a path of its own); the feed's
    rows; a Solver stopped after epoch 1 and resumed by a new one on both
    ranks from rank 0's `latest`, against an uninterrupted run (the ranks'
    final parameters' digests).  Paths are relative to the world's
    directory, the ranks' working directory."""
    import torch
    import torch.distributed as dist

    from graph_recsys_benchmark_tpu_torch.parallel import multihost as mh
    from graph_recsys_benchmark_tpu_torch.parallel.collectives import gather_digests
    from graph_recsys_benchmark_tpu_torch.train.solver import Solver
    from graph_recsys_benchmark_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    again = mh.initialize_runtime("file:///nonexistent/store", 2, mesh.rank, device="cpu")
    lin = torch.nn.Linear(2, 2)
    save_checkpoint(os.path.join(f"ckpt_{mesh.rank}", "latest.ckpt"), lin,
                    torch.optim.Adam(lin.parameters()), 1, {})
    exists = [os.path.isfile(os.path.join(f"ckpt_{r}", "latest.ckpt")) for r in range(2)]
    rows, masks = zip(*mh.HostBatchFeed(100, 32, mesh).batches(7))

    pea, _ = trainers_setup(mesh=mesh, conv="gcn")
    run_epoch, entries = pea.run_epoch, []

    def epoch(params, optimizer, generator, stop_at=None):
        entries.append(gather_digests(list(params.parameters()), mesh))
        if len(entries) == stop_at:
            raise KeyboardInterrupt
        return run_epoch(params, optimizer, generator)

    kw = dict(runs=1, epochs=2, init_eval=False, save_epochs=(), save_every_epoch=0)
    pea.run_epoch = lambda p, o, g: epoch(p, o, g, stop_at=2)
    try:
        Solver(pea, "stopped", **kw).run()
    except KeyboardInterrupt:
        pass
    stopped = list(entries)
    entries.clear()
    pea.run_epoch = epoch
    Solver(pea, "stopped", **kw).run()
    params = pea.init(0)  # every rank reads rank 0's file
    load_checkpoint(os.path.join("stopped", "run_1", "latest.ckpt"), params,
                    pea.optimizer(params))
    return {"again": np.asarray(again), "backend": np.asarray(mh.RUNTIME["backend"]),
            "world": np.asarray(dist.get_world_size()), "exists": np.asarray(exists),
            "rows": np.concatenate([r.numpy() for r in rows]),
            "masks": np.concatenate([m.numpy() for m in masks]),
            "stopped": np.asarray(stopped), "resumed": np.asarray(entries),
            "final": np.asarray(gather_digests(list(params.parameters()), mesh)),
            "files": np.asarray(sorted(os.listdir("stopped")))}


# ---------------------------------------------------- the row-sharded table


def tiny_a2a_setup(conv, entity_aware=False, heads=1, n_nodes=200, seed=0):
    """The JAX tests/test_sharded_embedding.py _tiny_setup (numpy only):
    (PEAConfig keywords, metapath edges of 3 channels, batch int32 [64, 3
    or 9], row mask)."""
    rng = np.random.default_rng(seed)
    c = 3
    edges = [[rng.integers(0, n_nodes, size=(2, 600)).astype(np.int64) for _ in range(2)]
             for _ in range(c)]
    cfg = dict(conv=conv, num_nodes=n_nodes, meta_path_steps=(2,) * c, emb_dim=16,
               hidden_size=16, repr_dim=8, num_heads=heads, channel_aggr="att",
               entity_aware=entity_aware, fused=True)
    b = 64
    batch = rng.integers(0, n_nodes, size=(b, 9 if entity_aware else 3)).astype(np.int32)
    if entity_aware:
        batch[:, 5] = rng.integers(0, 2, size=b) * 2 - 1
        batch[:, 8] = rng.integers(0, 2, size=b) * 2 - 1
    return cfg, edges, batch, np.ones((b,), np.float32)


def task_row_collectives(mesh, inp):
    """all_to_all, all_gather and psum_scatter over two ranks: outputs,
    and the gradients of sum(out * ct_rank)."""
    import torch

    from graph_recsys_benchmark_tpu_torch.parallel.collectives import (
        STATS,
        all_gather,
        all_to_all,
        psum_scatter,
        reset_stats,
    )

    r = mesh.rank
    res = {}
    reset_stats()
    for name, fn in (("a2a", all_to_all), ("ag", all_gather), ("ps", psum_scatter)):
        x = torch.from_numpy(inp[f"{name}_x"][r]).requires_grad_()
        y = fn(x, mesh, "dp")
        (y * torch.from_numpy(inp[f"{name}_ct"][r])).sum().backward()
        res[f"{name}_y"], res[f"{name}_dx"] = y.detach().numpy(), x.grad.numpy()
    ids = all_to_all(torch.arange(4, dtype=torch.int32) + 10 * r, mesh, "dp")
    res["ids"] = ids.numpy()
    res["calls"] = np.asarray(STATS["calls"])
    res["ops"] = np.asarray(sorted(STATS["ops"]))
    return res


def task_lookups(mesh, inp):
    """sharded_lookup (twice: at a capacity that holds every bucket, and
    one that overflows a bucket) and static_lookup with the port's plan,
    on this rank's rows of inp['table']: values and the gradients of
    sum(out * ct_rank) on the rank's shard."""
    import torch

    from graph_recsys_benchmark_tpu_torch.parallel.sharded_embedding import (
        build_static_plan,
        lookup_overflowed,
        plan_arrays,
        sharded_lookup,
        static_lookup,
    )

    r = mesh.rank
    table = inp["table"]
    s = table.shape[0] // 2
    res = {}
    for name, cap in (("dyn", int(inp["cap"])), ("over", int(inp["cap_over"]))):
        shard = torch.from_numpy(table[r * s:(r + 1) * s].copy()).requires_grad_()
        idx = torch.from_numpy(inp["idx"][r])
        out = sharded_lookup(shard, idx, mesh, "dp", cap)
        (out * torch.from_numpy(inp["ct"][r])).sum().backward()
        res[f"{name}_out"], res[f"{name}_grad"] = out.detach().numpy(), shard.grad.numpy()
        res[f"{name}_overflowed"] = np.asarray(lookup_overflowed(idx, s, 2, cap))
    plan = build_static_plan(inp["sidx"], s, 2)
    arr = plan_arrays(plan, r, torch.device("cpu"))
    shard = torch.from_numpy(table[r * s:(r + 1) * s].copy()).requires_grad_()
    out = static_lookup(shard, arr["own"], arr["pos"], arr["serve"], mesh, "dp",
                        plan["capacity"])
    (out * torch.from_numpy(inp["sct"][r])).sum().backward()
    res["static_out"], res["static_grad"] = out.detach().numpy(), shard.grad.numpy()
    return res


def _pea(cfg_kw):
    import torch

    from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig, pea_init

    cfg = PEAConfig(**cfg_kw)
    return cfg, pea_init(torch.Generator().manual_seed(0), cfg)


def task_a2a_step(mesh, inp, conv, entity_aware=False, heads=1, adam=False):
    """The a2a step (make_a2a_parts) on the tiny setup, this rank's rows of
    its batch: the total loss, the gradients (x's this rank's rows) and,
    with `adam`, the parameters after one Adam step."""
    import torch

    from graph_recsys_benchmark_tpu_torch.models.params import to_numpy
    from graph_recsys_benchmark_tpu_torch.parallel.a2a import make_a2a_parts
    from graph_recsys_benchmark_tpu_torch.parallel.collectives import STATS, reset_stats
    from graph_recsys_benchmark_tpu_torch.train.optim import make_optimizer

    cfg_kw, edges, batch, mask = tiny_a2a_setup(conv, entity_aware, heads)
    cfg, params = _pea(cfg_kw)
    parts = make_a2a_parts(cfg, edges, mesh)
    parts["shard"](params)
    b, m = parts["place"](torch.from_numpy(batch).long(), torch.from_numpy(mask))
    reset_stats()
    loss = parts["grads"](params, b, m)
    res = {"loss": loss.numpy(), "ops": np.asarray(sorted(STATS["ops"])),
           **flat("grad", grad_tree(params))}
    if adam:
        make_optimizer("adam", 1e-3, 1e-3)(params.parameters()).step()
        res.update(flat("param", to_numpy(params)))
    return res


def task_a2a_dropout(mesh, inp):
    """GAT at dropout 0.3 through the a2a step from one epoch generator:
    the loss with and without the masks, and this rank's keep masks'
    share of one step draw (a2a.rank_generator as the forward uses it)."""
    import dataclasses

    import torch

    from graph_recsys_benchmark_tpu_torch.parallel.a2a import make_a2a_parts, rank_generator

    cfg_kw, edges, batch, mask = tiny_a2a_setup("gat")
    cfg, params = _pea(cfg_kw)
    cfg = dataclasses.replace(cfg, dropout=0.3)
    parts = make_a2a_parts(cfg, edges, mesh)
    parts["shard"](params)
    b, m = parts["place"](torch.from_numpy(batch).long(), torch.from_numpy(mask))
    losses = [float(parts["grads"](params, b, m, gen))
              for gen in (None, torch.Generator().manual_seed(3))]
    e_loc = parts["setup"]["graphs"][0].dst.shape[0]
    keep = torch.rand((e_loc, 1), generator=rank_generator(
        torch.Generator().manual_seed(3), mesh.rank)) < 0.7
    return {"losses": np.asarray(losses), "keep": keep.numpy()[:, 0]}


def task_dp_step(mesh, inp, conv, entity_aware=False, dropout=0.0):
    """The dp step (spmd.make_sharded_train_step) on the tiny setup over
    the trainer's union graphs, mp 2 (dp the world / 2): the total loss,
    the gradients (x's the rows of this rank's mp index) and the rank's
    (d, m).  With `dropout` the step gets a generator seeded 3 and GAT
    drops attention under the union masks of inp ('keep0', 'keep1': the
    JAX package's) or, without an input, under those the step draws from
    the generator; the masks it used are returned ('keep/0', 'keep/1')."""
    import dataclasses

    import torch

    from graph_recsys_benchmark_tpu_torch.graph import build_fused_metapath_graphs
    from graph_recsys_benchmark_tpu_torch.models.pea import DropoutMasks
    from graph_recsys_benchmark_tpu_torch.parallel import spmd
    from graph_recsys_benchmark_tpu_torch.parallel.multihost import make_pod_mesh

    m2 = make_pod_mesh(mp=2, device="cpu")
    cfg_kw, edges, batch, mask = tiny_a2a_setup(conv, entity_aware)
    cfg, params = _pea(cfg_kw)
    cfg = dataclasses.replace(cfg, dropout=dropout)
    used = {}
    own_draw = DropoutMasks.draw

    def draw(self, c, k, g, heads):
        assert c is None, f"a per-channel draw ({c}, {k}) on union graphs"
        keep = torch.from_numpy(inp[f"keep{k}"]) if inp else own_draw(self, c, k, g, heads)
        used[f"keep/{k}"] = keep.numpy()
        return keep

    graphs = build_fused_metapath_graphs(edges, cfg.num_nodes, conv)
    step, place = spmd.make_sharded_train_step(cfg, graphs, m2)
    spmd.shard_table(params, m2)
    b, m = place(torch.from_numpy(batch).long(), torch.from_numpy(mask))
    gen = torch.Generator().manual_seed(3) if dropout else None
    DropoutMasks.draw = draw
    try:
        loss = step.grads(params, b, m, gen)
    finally:
        DropoutMasks.draw = own_draw
    return {"loss": loss.numpy(), "coords": np.asarray([m2.axis_index("dp"),
                                                         m2.axis_index("mp")]),
            **used, **flat("grad", grad_tree(params))}


def task_row_sharded_trainer(mesh, inp, mode):
    """ShardedPEATrainer (PEAGAT entity-aware on the trainers' world, mode
    'a2a' or 'dp' at mp 2): two epochs from TRAIN_SEED on one generator,
    the eval, the full-catalog ranks, the whole trained parameters, and a
    checkpoint round trip (both ranks save, rank 0 writes; a fresh init
    resumes from the file: the same rows and moments)."""
    import torch

    from graph_recsys_benchmark_tpu_torch.parallel.collectives import full_rows
    from graph_recsys_benchmark_tpu_torch.parallel.engine import ShardedPEATrainer
    from graph_recsys_benchmark_tpu_torch.parallel.multihost import make_pod_mesh
    from graph_recsys_benchmark_tpu_torch.models.params import to_numpy
    from graph_recsys_benchmark_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    base, _ = trainers_setup(device="cpu")
    m = mesh if mode == "a2a" else make_pod_mesh(mp=2, device="cpu")
    sh = ShardedPEATrainer(base.hin, base.cfg, base.tcfg, mesh=m, mode=mode)
    params = sh.init(TRAIN_SEED)
    opt = sh.optimizer(params)
    gen = torch.Generator().manual_seed(EPOCH_SEED)
    out = {"losses": np.asarray([float(sh.run_epoch(params, opt, gen)) for _ in range(2)])}
    ev = sh.evaluate(params, torch.Generator().manual_seed(EVAL_SEED))
    for k in ("HR", "NDCG", "AUC", "eval_loss"):
        out[k] = np.asarray(ev[k])
    out["full_ranks"] = sh.evaluate_full(params)["ranks"].numpy()
    path = os.path.join(f"ckpt_{mode}", "latest.ckpt")
    save_checkpoint(path, params, opt, 2, {})
    p2 = sh.init(0)
    o2 = sh.optimizer(p2)
    load_checkpoint(path, p2, o2)
    out["same_params"] = np.asarray(all(torch.equal(a, b) for a, b in
                                        zip(params.parameters(), p2.parameters())))
    s1, s2 = opt.state_dict()["state"], o2.state_dict()["state"]
    out["same_moments"] = np.asarray(all(
        torch.equal(torch.as_tensor(s1[i][k]), torch.as_tensor(s2[i][k]))
        for i in s1 for k in s1[i]))
    saved = torch.load(path, weights_only=True)
    out["file_x_rows"] = np.asarray(saved["params"]["x"].shape[0])
    out["file_moment_rows"] = np.asarray(saved["opt_state"]["state"][0]["exp_avg"].shape[0])
    out["x_rows"] = np.asarray(params.x.shape[0])
    axis = "dp" if mode == "a2a" else "mp"
    whole = to_numpy(params)
    whole["x"] = full_rows(params.x, m, axis).numpy()
    out.update(flat("param", whole))
    return out


TASKS = {"collectives": task_collectives, "softmax_aggregate": task_softmax_aggregate,
         "stream": task_stream, "fused_step": task_fused_step, "stream_step": task_stream_step,
         "trainers": task_trainers, "runtime": task_runtime,
         "row_collectives": task_row_collectives, "lookups": task_lookups,
         "a2a_step": task_a2a_step, "a2a_dropout": task_a2a_dropout,
         "dp_step": task_dp_step, "row_sharded_trainer": task_row_sharded_trainer}


def _main(spec_path, rank):
    import torch

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    from graph_recsys_benchmark_tpu_torch.parallel.multihost import (
        initialize_runtime,
        make_pod_mesh,
    )

    assert initialize_runtime(spec["store"], spec["nprocs"], rank, device="cpu")
    mesh = make_pod_mesh(mp=1, device="cpu")
    for name, kw in spec["tasks"].items():
        path = os.path.join(spec["dir"], f"{name}.in.npz")
        inp = {}
        if os.path.isfile(path):
            with np.load(path) as z:
                inp = {k: z[k] for k in z.files}
        fn = TASKS[kw.pop("task", name)]
        out = fn(mesh, inp, **kw)
        np.savez(os.path.join(spec["dir"], f"{name}.{rank}.npz"), **out)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _main(sys.argv[1], int(sys.argv[2]))
