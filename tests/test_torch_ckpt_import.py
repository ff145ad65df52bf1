"""Reference-checkpoint import (utils/torch_import.py) against the JAX
package's on the CPU.

The reference's pre-trained checkpoints are not on these machines, so the
files here are synthetic: torch pickles in the reference's layout
({'epoch', 'model_states', 'optim_states', 'rec_metrics'}) whose state dict
names follow both module-naming generations (``pea_channels.N.gnn_layers.K``
and the older ``mpa<conv>_channels.N.<conv>_layers.K``), for gcn, gat and
sage.  Held: the loaded state dict, history and epoch and the converted
arrays bitwise the JAX package's; the imported module (models/params) the
same arrays; the imported PEAGAT forward the JAX forward of the JAX import
at the slice tests' bar (f32, 2e-5, tests/test_torch_pea_slice.py); a
config that does not fit the file raises; without a card the import
raises unless the caller asks for the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu import graph as jgraph
from graph_recsys_benchmark_tpu.data import movielens as jml
from graph_recsys_benchmark_tpu.data import synthetic as jsyn
from graph_recsys_benchmark_tpu.models import pea as jpea
from graph_recsys_benchmark_tpu.utils import torch_import as jimp
from graph_recsys_benchmark_tpu_torch import graph as tgraph
from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.data import synthetic as tsyn
from graph_recsys_benchmark_tpu_torch.models import params as tparams
from graph_recsys_benchmark_tpu_torch.models import pea as tpea
from graph_recsys_benchmark_tpu_torch.utils import torch_import as timp
from torch_ckpt_files import reference_state_dict, write_reference_checkpoint

SMALL = dict(emb_dim=16, hidden_size=16, repr_dim=8)
EPOCHS = 30


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_file(tmp_path, conv, generation, num_nodes=300, steps=(2, 1, 2)):
    """(path, JAX config, port config) of a synthetic reference checkpoint."""
    kw = dict(conv=conv, num_nodes=num_nodes, meta_path_steps=steps, **SMALL)
    jcfg, tcfg = jpea.PEAConfig(**kw), tpea.PEAConfig(**kw)
    tree = jax.tree_util.tree_map(np.asarray, jpea.pea_init(jax.random.PRNGKey(1), jcfg))
    path = str(tmp_path / f"{conv}{generation}.pkl")
    write_reference_checkpoint(path, reference_state_dict(tree, jcfg, generation), EPOCHS)
    return path, jcfg, tcfg


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("generation", [0, 1])
@pytest.mark.parametrize("conv", ["gcn", "gat", "sage"])
def test_converted_arrays_match_jax(tmp_path, conv, generation):
    path, jcfg, tcfg = _reference_file(tmp_path, conv, generation)
    jsd, jrec, jepoch = jimp.load_reference_checkpoint(path)
    tsd, trec, tepoch = timp.load_reference_checkpoint(path)
    assert tepoch == jepoch == EPOCHS and sorted(tsd) == sorted(jsd)
    for k in jsd:
        np.testing.assert_array_equal(tsd[k], jsd[k])
    assert sorted(trec) == sorted(jrec)
    for k in jrec:
        np.testing.assert_array_equal(trec[k], jrec[k])
    want = jimp.convert_pea_state(jsd, jcfg)
    _assert_trees_equal(timp.convert_pea_state(tsd, tcfg), want)
    model, rec, epoch = timp.import_reference_checkpoint(path, tcfg, device="cpu")
    assert isinstance(model, tpea.PEA) and epoch == EPOCHS and rec["HR"].shape == (EPOCHS, 16)
    assert all(p.device.type == "cpu" for p in model.parameters())
    _assert_trees_equal(tparams.to_numpy(model), want)


def test_imported_peagat_forward_matches_jax(tmp_path):
    raw = dict(seed=3, num_users=80, num_items=100)
    kw = dict(num_core=5, num_feat_core=3)
    jh = jml.build_mlsmall_hin(*jsyn.synthetic_mlsmall_raw(**raw), **kw)
    th = tml.build_mlsmall_hin(*tsyn.synthetic_mlsmall_raw(**raw), **kw)
    n = jh.num_nodes
    path, jcfg, tcfg = _reference_file(tmp_path, "gat", 0, num_nodes=n, steps=(2,) * 9)
    jparams, _, _ = jimp.import_reference_checkpoint(path, jcfg)
    model, _, _ = timp.import_reference_checkpoint(path, tcfg, device="cpu")
    jplan = jpea.build_hybrid_gat_plan(
        jgraph.build_metapath_graphs(jml.mlsmall_metapath_edges(jh), n, "gat"), n, jcfg)
    tplan = tpea.build_hybrid_gat_plan(
        tgraph.build_metapath_graphs(tml.mlsmall_metapath_edges(th), n, "gat"), n, tcfg)
    jrep = jpea.pea_forward(jax.tree_util.tree_map(jnp.asarray, jparams), jplan, jcfg)
    with torch.no_grad():
        trep = tpea.pea_forward(model, tplan, tcfg)
    assert trep.shape == (n, SMALL["repr_dim"])
    np.testing.assert_allclose(trep.numpy(), np.asarray(jrep), rtol=2e-5, atol=2e-5)


def test_import_refuses_a_config_that_does_not_fit(tmp_path, monkeypatch):
    path, _, tcfg = _reference_file(tmp_path, "sage", 1)
    sd, _, _ = timp.load_reference_checkpoint(path)
    wider = tpea.PEAConfig(conv="sage", num_nodes=301, meta_path_steps=(2, 1, 2), **SMALL)
    with pytest.raises(ValueError, match="x is"):
        timp.convert_pea_state(sd, wider)
    deeper = tpea.PEAConfig(conv="sage", num_nodes=300, meta_path_steps=(2, 2, 2), **SMALL)
    with pytest.raises(KeyError, match="channel-1 layer-1"):
        timp.convert_pea_state(sd, deeper)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timp.import_reference_checkpoint(path, tcfg)
