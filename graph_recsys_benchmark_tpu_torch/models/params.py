"""Carry model weights between the JAX package and the port.

The port keeps the JAX parameter layout and names (models/pea.PEA and the
baselines' ``nn/init.ParamTree`` modules), so the conversion is a copy in
both directions: ``from_jax_numpy`` takes the ``pea_init`` pytree with
numpy leaves (``jax.tree_util.tree_map(np.asarray, params)``) and
``to_numpy`` returns that structure; ``ngcf_*``, ``kg_*`` (KGAT and KGCN),
``cfkg_*`` and ``nfm_*`` do the same for the baselines' ``*_init`` trees,
NFM's as ``{"params", "state"}`` with the BatchNorm running statistics as
the module's buffers; ``walk_*`` and ``herec_*`` for the walk models'
stage-2 trees (HeRec's ``trans`` a tuple of ``{w, b}``).
"""

from __future__ import annotations

import numpy as np
import torch

from .cfkg import CFKG
from .herec import HeRec
from .kg import KG
from .nfm import NFM, STATE
from .ngcf import NGCF
from .pea import PEA
from .walk import Walk


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _a(p):
    return p.detach().cpu().numpy().copy()


def _map(fn, tree):
    """fn over the leaves of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_map(fn, v) for v in tree)
    return fn(tree)


def _tensors(tree):
    return _map(_t, tree)


def _arrays(module):
    return _map(_a, module.tree())


def from_jax_numpy(tree) -> PEA:
    """PEA module from the JAX ``pea_init`` pytree as numpy arrays."""
    channels = [
        [{k: _t(v) for k, v in layer.items()} for layer in ch]
        for ch in tree["channels"]
    ]
    return PEA(
        _t(tree["x"]),
        channels,
        {k: _t(v) for k, v in tree["fc1"].items()},
        {k: _t(v) for k, v in tree["fc2"].items()},
        att=_t(tree["att"]) if "att" in tree else None,
    )


def to_numpy(module: PEA) -> dict:
    """The JAX ``pea_init`` pytree layout with numpy leaves."""
    tree = {
        "x": _a(module.x),
        "channels": tuple(
            tuple({k: _a(v) for k, v in layer.items()} for layer in ch)
            for ch in module.channels
        ),
    }
    if module.att is not None:
        tree["att"] = _a(module.att)
    tree["fc1"] = {k: _a(v) for k, v in module.fc1.items()}
    tree["fc2"] = {k: _a(v) for k, v in module.fc2.items()}
    return tree


def ngcf_from_jax_numpy(tree) -> NGCF:
    """NGCF module from the JAX ``ngcf_init`` pytree as numpy arrays."""
    return NGCF(_tensors(tree))


def ngcf_to_numpy(module: NGCF) -> dict:
    return _arrays(module)


def kg_from_jax_numpy(tree) -> KG:
    """KGAT/KGCN module from the JAX ``kg_init`` pytree as numpy arrays."""
    return KG(_tensors(tree))


def kg_to_numpy(module: KG) -> dict:
    return _arrays(module)


def cfkg_from_jax_numpy(tree) -> CFKG:
    """CFKG module from the JAX ``cfkg_init`` pytree as numpy arrays."""
    return CFKG(_tensors(tree))


def cfkg_to_numpy(module: CFKG) -> dict:
    return _arrays(module)


def nfm_from_jax_numpy(tree) -> NFM:
    """NFM module from the JAX ``nfm_init`` tree {"params", "state"} as
    numpy arrays; the state becomes the module's buffers."""
    return NFM(_tensors(tree["params"]), {k: _t(tree["state"][k]) for k in STATE})


def nfm_to_numpy(module: NFM) -> dict:
    """The JAX {"params", "state"} tree with numpy leaves."""
    return {"params": _arrays(module), "state": {k: _a(v) for k, v in module.state().items()}}


def walk_from_jax_numpy(tree) -> Walk:
    """MetaPath2Vec's pair scorer from the JAX ``walk_init`` pytree as numpy
    arrays."""
    return Walk(_tensors(tree))


def walk_to_numpy(module: Walk) -> dict:
    return _arrays(module)


def herec_from_jax_numpy(tree) -> HeRec:
    """HeRec module from the JAX ``herec_init`` pytree as numpy arrays."""
    return HeRec(_tensors(tree))


def herec_to_numpy(module: HeRec) -> dict:
    return _arrays(module)
