"""HeRec: MF + per-metapath random-walk embedding fusion.

Port of the JAX package's ``models/herec.py`` (reference models/herec.py):

  score(u, i) = user_emb[u] . item_emb[i]
              + (Σ_k σ(W_k rk_k[u_nid])) . user_rk_bias[u]
              + (Σ_k σ(W_k rk_k[i_nid])) . item_rk_bias[i]

rk_k are the frozen per-metapath MetaPath2Vec embeddings, indexed by GLOBAL
node id (herec.py:38-45), tensors of the trainer and not parameters;
user_emb / item_emb / the biases are local (minus the type offsets).
Trained with MSE on ratings (herec_solver_bpr.py:20).  No kernel runs.
"""

from __future__ import annotations

import torch

from ..nn.init import ParamTree, glorot, torch_linear_bias


class HeRec(ParamTree):
    """HeRec in the JAX layout: ``user_emb``, ``user_rk_bias`` ``[num_users,
    D]``, ``item_emb``, ``item_rk_bias`` ``[num_items, D]``, and ``trans``,
    one ``{w [D, D], b [D]}`` a metapath."""


def herec_init(generator: torch.Generator, num_uids, num_iids, embedding_dim,
               num_metapaths) -> HeRec:
    """Random HeRec parameters from `generator` (CPU tensors), the
    distributions of the JAX ``herec_init`` (glorot tables and transforms,
    torch's default Linear bias)."""
    d = embedding_dim
    tree = {name: glorot(generator, (n, d)) for name, n in (
        ("user_emb", num_uids), ("item_emb", num_iids),
        ("user_rk_bias", num_uids), ("item_rk_bias", num_iids))}
    tree["trans"] = tuple({"w": glorot(generator, (d, d)), "b": torch_linear_bias(generator, d, d)}
                          for _ in range(num_metapaths))
    return HeRec(tree)


def _fused_rk(params: HeRec, rk_embeddings, nids):
    total = 0.0
    for tr, rk in zip(params.trans, rk_embeddings):
        total = total + torch.sigmoid(rk[nids] @ tr["w"] + tr["b"])
    return total


def herec_predict(params: HeRec, rk_embeddings, acc_uids, acc_iids, unids, inids):
    u_loc = unids - acc_uids
    i_loc = inids - acc_iids
    pred = torch.sum(params.user_emb[u_loc] * params.item_emb[i_loc], dim=-1)
    pred = pred + torch.sum(_fused_rk(params, rk_embeddings, unids) * params.user_rk_bias[u_loc],
                            dim=-1)
    pred = pred + torch.sum(_fused_rk(params, rk_embeddings, inids) * params.item_rk_bias[i_loc],
                            dim=-1)
    return pred


def herec_mse_loss(params: HeRec, rk_embeddings, acc_uids, acc_iids, pair, rating, row_mask):
    """Mean squared error of the rows with row_mask 1."""
    pred = herec_predict(params, rk_embeddings, acc_uids, acc_iids, pair[:, 0], pair[:, 1])
    n = torch.clamp(torch.sum(row_mask), min=1.0)
    return torch.sum(((pred - rating) ** 2) * row_mask) / n
