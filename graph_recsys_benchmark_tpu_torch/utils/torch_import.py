"""Import the reference's torch checkpoints into the port.

Port of the JAX package's ``utils/torch_import.py``.  The reference ships
pre-trained PEA checkpoints under
``experiments/checkpoint/weights/Movielenslatest-small/<MODEL>/BPR/.../run_1/
latest.pkl``: torch pickles holding {'epoch', 'model_states',
'optim_states', 'rec_metrics'} (reference utils/general_utils.py:40-53).
This module converts ``model_states['model']`` into the JAX package's PEA
parameter layout (numpy), which the port keeps, and returns it as the
port's ``PEA`` module (models/params.from_jax_numpy), with ``rec_metrics``,
the per-epoch HR/NDCG/AUC history that the reference recorded.

Tensor-layout mapping (PyG 1.5 / torch 1.5 conventions -> ours):
  x                      [N, emb]    -> x[:N] (rows padded to emb_rows)
  att                    [1, C, R]   -> att (identical)
  GCNConv   .weight      [in, out]   -> w (PyG stores it untransposed), .bias -> b
  GATConv   .lin.weight  [out, in]   -> w = weight.T (torch Linear layout)
            .att_i/.att_j [1,H,c]    -> att = concat([att_i, att_j], -1)
                                        (att_i is the DESTINATION half:
                                        PyG 1.5 alpha = (x_i*att_i)+(x_j*att_j))
            .bias        [H*c]       -> b
  SAGEConv  .lin_rel.weight [out,in] -> w_rel = T, .lin_rel.bias -> b_rel
            .lin_root.weight [out,in]-> w_root = T (the root path has no bias)
  fc1/fc2   .weight      [out, in]   -> w = weight.T, .bias -> b

``load_reference_checkpoint`` unpickles the whole file
(``weights_only=False``: it holds numpy arrays and tuples beside the
tensors), so only a checkpoint from a trusted source may be passed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def load_reference_checkpoint(path):
    """-> (state_dict {name: np.ndarray}, rec_metrics dict, epoch), read on
    the CPU."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.detach().numpy() for k, v in ck["model_states"]["model"].items()}
    hr, ndcg, auc, train_loss, eval_loss = ck["rec_metrics"]
    rec = {
        "HR": np.asarray(hr),
        "NDCG": np.asarray(ndcg),
        "AUC": np.asarray(auc),
        "train_loss": np.asarray(train_loss),
        "eval_loss": np.asarray(eval_loss),
    }
    return sd, rec, int(ck["epoch"])


def _prefix(sd, cfg, c, k):
    """The state dict's name prefix of channel c, layer k.  The shipped
    checkpoints span two module-naming generations: the current
    ``pea_channels.N.gnn_layers.K`` (models/base.py:166) and an older
    ``mpa<conv>_channels.N.<conv>_layers.K`` (the non-entity-aware PEAGCN
    checkpoint was trained before the rename)."""
    for pre in (f"pea_channels.{c}.gnn_layers.{k}.",
                f"mpa{cfg.conv}_channels.{c}.{cfg.conv}_layers.{k}."):
        if any(name.startswith(pre) for name in sd):
            return pre
    raise KeyError(f"no channel-{c} layer-{k} weights in state dict")


def _layer(sd, pre, conv):
    def f32(name, transpose=False):
        a = sd[pre + name]
        return (a.T if transpose else a).astype(np.float32)

    if conv == "gcn":
        return {"w": f32("weight"), "b": f32("bias")}
    if conv == "gat":
        att = np.concatenate([sd[pre + "att_i"], sd[pre + "att_j"]], axis=-1)
        return {"w": f32("lin.weight", True), "att": att.astype(np.float32), "b": f32("bias")}
    if conv == "sage":
        return {"w_rel": f32("lin_rel.weight", True), "b_rel": f32("lin_rel.bias"),
                "w_root": f32("lin_root.weight", True)}
    raise ValueError(conv)


def convert_pea_state(sd, cfg):
    """Reference PEA state dict -> the JAX package's ``pea_init`` layout with
    numpy leaves for `cfg` (models/pea.PEAConfig; the shapes must agree)."""
    n, emb = sd["x"].shape
    if (n, emb) != (cfg.num_nodes, cfg.emb_dim):
        raise ValueError(f"x is [{n}, {emb}], the config wants [{cfg.num_nodes}, "
                         f"{cfg.emb_dim}]")
    x = np.zeros((cfg.emb_rows, emb), np.float32)
    x[:n] = sd["x"]
    params = {"x": x}
    params["channels"] = tuple(
        tuple(_layer(sd, _prefix(sd, cfg, c, k), cfg.conv) for k in range(cfg.meta_path_steps[c]))
        for c in range(cfg.num_channels)
    )
    if cfg.channel_aggr == "att":
        params["att"] = sd["att"].astype(np.float32)
    for fc in ("fc1", "fc2"):
        params[fc] = {"w": sd[fc + ".weight"].T.astype(np.float32),
                      "b": sd[fc + ".bias"].astype(np.float32)}
    return params


def import_reference_checkpoint(path, cfg, device=None):
    """One-call migration: reference latest.pkl -> (the port's PEA module on
    `device` (None: the card), rec_metrics, epoch)."""
    from ..models.params import from_jax_numpy

    dev = resolve_device(device)
    sd, rec, epoch = load_reference_checkpoint(path)
    return from_jax_numpy(convert_pea_state(sd, cfg)).to(dev), rec, epoch
