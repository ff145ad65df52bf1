"""Port parity for PEAGAT of mixed depth under attention dropout
(tests/torch_per_channel_world.py's 'mixed' table): the training forward
runs the ungrouped forward with the JAX package's own keep masks (its key
schedule there: ``split(fold_in(key, c), depth of c)[k]``, then
``bernoulli(dk, 1 - p, [E, heads])``, JAX nn/conv.py:154), one draw a
conv, and the loss and every gradient match: the loss within 1e-5
relative, every gradient within 1e-5 of its largest value.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu_torch.models import params as tparams
from graph_recsys_benchmark_tpu_torch.models import pea as tpea
from torch_per_channel_world import (
    MIXED,
    build_world,
    configs,
    grad_tree,
    jax_reference,
    leaf_errors,
    make_batch,
    setup,
)

P = 0.3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one torch thread beside the other pytest workers
    (test_torch_ml25m_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return build_world()


class JaxMasks(tpea.DropoutMasks):
    """The JAX package's keep masks on its ungrouped forward (module
    docstring)."""

    def __init__(self, p, key, depths):
        super().__init__(p)
        self.key, self.depths = key, depths

    def draw(self, c, k, g, heads):
        assert not g.gat_loops
        dk = jax.random.split(jax.random.fold_in(self.key, c), self.depths[c])[k]
        return torch.from_numpy(np.array(
            jax.random.bernoulli(dk, 1.0 - self.p, (g.dst.shape[0], heads))))


def test_mixed_gat_dropout_with_jax_masks_matches_jax(world, monkeypatch):
    jg, trainer, params = setup(world, "gat", "mixed")
    jcfg, tcfg = (dataclasses.replace(c, dropout=P) for c in configs(world, "gat", "mixed"))
    batch, mask = make_batch(world.thin, seed=1)
    key = jax.random.PRNGKey(11)
    _, jloss, jgrads = jax_reference(monkeypatch, jg, jcfg, params, batch, mask, "f32",
                                     training=True, dropout_key=key)
    model = tparams.from_jax_numpy(params)
    masks = JaxMasks(P, key, MIXED)
    loss = tpea.pea_loss(model, trainer.graphs, tcfg, torch.from_numpy(batch),
                         row_mask=torch.from_numpy(mask), masks=masks)
    loss.backward()
    assert len(masks._drawn) == sum(MIXED)  # every conv, one draw each
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    errs = leaf_errors(grad_tree(model), jgrads)
    assert errs[-1] <= 1e-5, errs
    with torch.no_grad():  # the masks were used: without them the loss moves
        plain = tpea.pea_loss(model, trainer.graphs, tcfg, torch.from_numpy(batch),
                              row_mask=torch.from_numpy(mask))
    assert abs(float(plain) - float(loss.detach())) > 1e-3 * abs(float(plain))
