"""Port parity for PEAGAT with ``fused=False`` on the uniform table: the
trainer runs the per-channel graphs on the grouped forward
(models/pea._grouped_gat_forward, every conv a composed nn/conv.gat_apply
at this size), as the JAX trainer does (its train/pea_trainer.py:53-78),
against the JAX package (tests/torch_per_channel_world.py's 'unfused'
table).

Forward, the entity-aware loss with a partial row mask and every gradient
match: f32 within 1e-5 relative (gradients 1e-5 of their largest value);
bf16 transport at 1e-3 and every leaf 5e-2, the median leaf at 2e-3, half
a unit of bf16's last place.  The composed GAT's bf16 gradients of `x`
differ from the JAX package's by rounding flips in a few rows (measured
here: the median leaf is `x`, 1.015e-3 of its largest value, from 39 of
its 240 rows, each about 1 % of its own row's size, the loss bitwise the
same; the JAX side op by op and jitted agree to 1e-8), which the softmax's
bf16 roundings amplify under another summation order.
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


def test_trainer_routes_per_channel_graphs_as_jax(world):
    check_routing(world, "gat", "unfused")


@pytest.mark.parametrize("transport", ["f32", "bf16"])
def test_forward_loss_and_grads_match_jax(world, monkeypatch, transport):
    check_parity(world, monkeypatch, "gat", "unfused", transport, median_bf16=2e-3)
