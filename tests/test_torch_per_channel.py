"""Port parity for PEAGCN on the per-channel graphs: the ungrouped forward
(models/pea._channel_forward, nn/conv.gcn_apply) on metapaths of mixed
depth and with ``fused=False`` on the uniform table
(tests/torch_per_channel_world.py), against the JAX package.

For each table: the port's trainer routes the per-channel graphs,
equal to the JAX package's array for array; forward, the entity-aware loss
with a partial row mask and every gradient match, f32 within 1e-5
relative (gradients 1e-5 of their largest value), bf16 transport at
test_torch_gcn_sage_slice.py's bars (1e-3, the median leaf 1e-3, every
leaf 5e-2).  Also: ``segment_mean`` against the JAX package's, and the
converter carrying the weights of mixed depths both ways.  PEASage's
parity is in test_torch_per_channel_sage.py, PEAGAT's in
test_torch_per_channel_gat.py, _grouped.py and _dropout.py (a file each,
so that no file's JAX compiles pass 20 s of a worker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu.models import pea as jpea
from graph_recsys_benchmark_tpu.ops import segment as jseg
from graph_recsys_benchmark_tpu_torch.models import params as tparams
from graph_recsys_benchmark_tpu_torch.models import pea as tpea
from graph_recsys_benchmark_tpu_torch.ops import segment as tseg
from torch_per_channel_world import build_world, check_parity, check_routing, configs


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
    check_routing(world, "gcn", table)


@pytest.mark.parametrize("transport", ["f32", "bf16"])
@pytest.mark.parametrize("table", ["mixed", "unfused"])
def test_forward_loss_and_grads_match_jax(world, monkeypatch, table, transport):
    check_parity(world, monkeypatch, "gcn", table, transport)


@pytest.mark.parametrize("shape", [(50,), (50, 3), (50, 2, 4)])
def test_segment_mean_matches_jax(shape):
    """Empty segments give 0, padding ids (>= num_segments) drop out."""
    rng = np.random.default_rng(len(shape))
    data = rng.standard_normal(shape).astype(np.float32)
    ids = rng.integers(0, 9, shape[0]).astype(np.int32)  # 8: the padding sentinel
    ids[ids == 7] = 3  # segment 7 empty
    want = np.asarray(jseg.segment_mean(jnp.asarray(data), jnp.asarray(ids), 8))
    got = tseg.segment_mean(torch.from_numpy(data), torch.from_numpy(ids), 8).numpy()
    assert got.shape == want.shape and not got[7].any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("conv", ["gcn", "sage", "gat"])
def test_converter_carries_mixed_depths(world, conv):
    """models/params carries a mixed-depth pytree both ways exactly, and
    the port's pea_init draws the JAX layout (its shapes and dtypes, traced
    by jax.eval_shape): channel 0 one layer (emb -> repr), the rest two."""
    jcfg, tcfg = configs(world, conv, "mixed")
    port = tparams.to_numpy(tpea.pea_init(torch.Generator().manual_seed(0), tcfg))
    back = tparams.to_numpy(tparams.from_jax_numpy(port))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(port)
    for a, b in zip(jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    shapes = jax.eval_shape(lambda k: jpea.pea_init(k, jcfg), jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(port)
    for a, b in zip(jax.tree_util.tree_leaves(shapes), jax.tree_util.tree_leaves(port)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert len(port["channels"][0]) == 1 and len(port["channels"][1]) == 2
    first = port["channels"][0][0]
    assert first["w_rel" if conv == "sage" else "w"].shape == (16, 8)
