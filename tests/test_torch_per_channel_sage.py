"""Port parity for PEASage on the per-channel graphs (the ungrouped
forward, nn/conv.sage_apply) on metapaths of mixed depth and with
``fused=False`` on the uniform table (tests/torch_per_channel_world.py),
against the JAX package.

For each table: the trainer routes the per-channel graphs, equal to the
JAX package's array for array; forward, the entity-aware loss with a
partial row mask and every gradient match, f32 within 1e-5 relative
(gradients 1e-5 of their largest value), bf16 transport at 1e-3, the
median leaf 1e-3 and every leaf 5e-2.
"""

import pytest
import torch

from torch_per_channel_world import build_world, check_parity, check_routing


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


@pytest.mark.parametrize("table", ["mixed", "unfused"])
def test_trainer_routes_per_channel_graphs_as_jax(world, table):
    check_routing(world, "sage", table)


@pytest.mark.parametrize("transport", ["f32", "bf16"])
@pytest.mark.parametrize("table", ["mixed", "unfused"])
def test_forward_loss_and_grads_match_jax(world, monkeypatch, table, transport):
    check_parity(world, monkeypatch, "sage", table, transport)
