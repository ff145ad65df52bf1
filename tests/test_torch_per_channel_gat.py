"""Port parity for PEAGAT on metapaths of mixed depth: the ungrouped
forward (models/pea._channel_forward, one composed nn/conv.gat_apply a
channel and step: K7, K8, K5 and K6) against the JAX package
(tests/torch_per_channel_world.py's 'mixed' table).

The trainer routes the per-channel graphs as the JAX package builds them;
forward, the entity-aware loss with a partial row mask and every gradient
match, f32 within 1e-5 relative (gradients 1e-5 of their largest value),
bf16 transport at 1e-3, the median leaf 1e-3 and every leaf 5e-2.  The
hybrid plan refuses mixed depths with a ValueError.  The same forward under
attention dropout is held in test_torch_per_channel_dropout.py, so that no
file's JAX compiles pass 20 s of a worker.
"""

import pytest
import torch

from graph_recsys_benchmark_tpu_torch.models import pea as tpea
from torch_per_channel_world import build_world, check_parity, check_routing, configs, setup


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


def test_trainer_routes_per_channel_graphs_as_jax(world):
    check_routing(world, "gat", "mixed")


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_forward_loss_and_grads_match_jax(world, monkeypatch, transport):
    check_parity(world, monkeypatch, "gat", "mixed", transport)


def test_hybrid_plan_refuses_mixed_depths(world):
    _, tcfg = configs(world, "gat", "mixed")
    _, trainer, _ = setup(world, "gat", "mixed")
    with pytest.raises(ValueError, match="one depth"):
        tpea.build_hybrid_gat_plan(trainer.graphs, tcfg.num_nodes, tcfg)
