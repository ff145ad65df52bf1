"""Set-up of a run: caches inside the checkout, the program's import, the
dataset (cached by the configuration), the trainer.

Every cache sits at a fixed path inside the checkout
(portbench/.cache/, git-ignored): the dataset as a pickle keyed by the
configuration's dataset section and the program's data sources, and
``TORCH_EXTENSIONS_DIR`` / ``TRITON_CACHE_DIR`` for any build that honours
them.  The program's own kernels build into its package's ``_build``
directory, inside the checkout too.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import pickle

from .spec import BENCH_DIR

CACHE_DIR = os.path.join(BENCH_DIR, ".cache")
PROGRAM = "graph_recsys_benchmark_tpu_torch"


def set_cache_dirs():
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)


def resolve(dotted: str):
    """The object `package.module.name` names."""
    module, _, name = dotted.rpartition(".")
    return getattr(importlib.import_module(module), name)


def _dataset_key(config):
    h = hashlib.sha256(json.dumps(config["dataset"], sort_keys=True).encode())
    data_dir = os.path.dirname(importlib.import_module(PROGRAM + ".data").__file__)
    for f in sorted(os.listdir(data_dir)):
        if f.endswith(".py"):
            with open(os.path.join(data_dir, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()[:16]


def build_dataset(config):
    """Run the configuration's dataset pipeline: each stage's function on
    the previous stage's output (a tuple unpacked) and its kwargs."""
    out = None
    for stage in config["dataset"]["pipeline"]:
        fn = resolve(stage["fn"])
        args = () if out is None else (out if isinstance(out, tuple) else (out,))
        out = fn(*args, **stage.get("kwargs", {}))
    return out


def load_dataset(config, cache_dir=None):
    """The dataset, from the cache when a run of this checkout built it."""
    path = os.path.join(cache_dir or CACHE_DIR, "data", f"{config['name']}-{_dataset_key(config)}.pkl")
    if os.path.isfile(path):
        with open(path, "rb") as fh:
            return pickle.load(fh)
    hin = build_dataset(config)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        pickle.dump(hin, fh, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return hin


@dataclasses.dataclass
class Env:
    config: dict
    device: object
    hin: object
    trainer: object
    steps_per_channel: tuple
    model_cls: object
    traffic: dict = None


def prepare(config, traffic, device):
    """The dataset and the program's trainer for `config` on `device`."""
    set_cache_dirs()
    importlib.import_module(PROGRAM)
    hin = load_dataset(config)
    steps = tuple(len(mp) for mp in config["metapaths"])
    model = dict(config["model"])
    model.pop("table_bound")
    mcfg = resolve(config["classes"]["model_config"])(
        num_nodes=hin.num_nodes, meta_path_steps=steps, **model)
    tcfg = resolve(config["classes"]["train_config"])(**config["train"])
    edges = resolve(config["metapath_edges"])(hin)
    trainer = resolve(config["classes"]["trainer"])(
        hin, mcfg, tcfg, edges, device=device, transport=config["transport"])
    return Env(config=config, device=trainer.device, hin=hin, trainer=trainer,
               steps_per_channel=steps, model_cls=resolve(config["classes"]["model"]),
               traffic=traffic)
