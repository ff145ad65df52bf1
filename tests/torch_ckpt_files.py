"""Synthetic reference checkpoints that the port's import tests (and
chip_smoke.py's import phase) write: a PEA parameter tree in the JAX
layout (numpy leaves), renamed into the reference's state dict and saved
as its ``latest.pkl`` layout ({'epoch', 'model_states', 'optim_states',
'rec_metrics'})."""

import numpy as np
import torch


def reference_state_dict(tree, cfg, generation=0):
    """The reference's state dict of the JAX-layout `tree` for `cfg` (a
    PEAConfig of either package): the inverse of convert_pea_state's
    mapping, in naming generation 0 (current) or 1."""
    sd = {"x": tree["x"][:cfg.num_nodes]}
    for c, layers in enumerate(tree["channels"]):
        for k, layer in enumerate(layers):
            pre = (f"pea_channels.{c}.gnn_layers.{k}." if generation == 0
                   else f"mpa{cfg.conv}_channels.{c}.{cfg.conv}_layers.{k}.")
            if cfg.conv == "gcn":
                sd[pre + "weight"], sd[pre + "bias"] = layer["w"], layer["b"]
            elif cfg.conv == "gat":
                half = layer["att"].shape[-1] // 2
                sd[pre + "lin.weight"] = layer["w"].T
                sd[pre + "att_i"] = layer["att"][..., :half]
                sd[pre + "att_j"] = layer["att"][..., half:]
                sd[pre + "bias"] = layer["b"]
            else:
                sd[pre + "lin_rel.weight"] = layer["w_rel"].T
                sd[pre + "lin_rel.bias"] = layer["b_rel"]
                sd[pre + "lin_root.weight"] = layer["w_root"].T
    if "att" in tree:
        sd["att"] = tree["att"]
    for fc in ("fc1", "fc2"):
        sd[fc + ".weight"], sd[fc + ".bias"] = tree[fc]["w"].T, tree[fc]["b"]
    return sd


def write_reference_checkpoint(path, sd, epochs, seed=0):
    """`sd` saved as a reference ``latest.pkl`` at epoch `epochs`, with an
    `epochs`-long history (HR, NDCG [epochs, 16]; AUC, train and eval loss
    [epochs, 1]) drawn from `seed`."""
    rng = np.random.default_rng(seed)
    rec = (rng.uniform(size=(epochs, 16)), rng.uniform(size=(epochs, 16)),
           rng.uniform(size=(epochs, 1)), rng.uniform(size=(epochs, 1)),
           rng.uniform(size=(epochs, 1)))
    torch.save({"epoch": epochs,
                "model_states": {"model": {k: torch.tensor(np.array(v))
                                           for k, v in sd.items()}},
                "optim_states": {"model": {"state": {}, "param_groups": []}},
                "rec_metrics": rec}, path)
