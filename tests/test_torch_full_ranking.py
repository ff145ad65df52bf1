"""The port's full-catalog ranking (eval/full_ranking.py) and the rejection
candidate mode of its ml-latest-small builder, against the JAX package.

Both packages build the HIN from the same raw frames in the dense and the
rejection candidate modes; the tables are compared bitwise.  A dot-product
score over embeddings from a numpy seed then ranks every test user's
positive against the whole catalog in both packages: the port's ranks must
equal the JAX ``evaluate_full_ranking`` ranks and the numpy oracle of
tests/test_full_ranking.py exactly (a strict ``>``, ties favour the
positive), with chunks of users that do not divide the user count.  Last,
``PEATrainer.evaluate_full`` on the CPU: HR@k never falls as k grows.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_recsys_benchmark_tpu.data import movielens as jml
from graph_recsys_benchmark_tpu.data import synthetic as jsyn
from graph_recsys_benchmark_tpu.eval.full_ranking import evaluate_full_ranking as j_full
from graph_recsys_benchmark_tpu.train import sampling as jsamp
from graph_recsys_benchmark_tpu_torch.data import movielens as tml
from graph_recsys_benchmark_tpu_torch.eval.full_ranking import evaluate_full_ranking
from graph_recsys_benchmark_tpu_torch.models.pea import PEAConfig
from graph_recsys_benchmark_tpu_torch.train import sampling as tsamp
from graph_recsys_benchmark_tpu_torch.train.pea_trainer import PEATrainer, TrainConfig

RAW = dict(seed=0, num_users=50, num_items=40, min_ratings_per_user=5, max_ratings_per_user=10)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops beside the other pytest workers: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["dense", "rejection"])
def hins(request):
    raw = jsyn.synthetic_mlsmall_raw(**RAW)
    kw = dict(num_core=2, num_feat_core=1, candidate_mode=request.param)
    return (tml.build_mlsmall_hin(*(f.copy() for f in raw), **kw),
            jml.build_mlsmall_hin(*(f.copy() for f in raw), **kw))


def test_candidate_tables_equal_jax(hins):
    thin, jhin = hins
    assert type(thin.candidates).__name__ == type(jhin.candidates).__name__
    for f in dataclasses.fields(jhin.candidates):
        a, b = getattr(thin.candidates, f.name), getattr(jhin.candidates, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_array_equal(thin.train_pos, jhin.train_pos)


@pytest.mark.parametrize("chunk_users", [7, 128])
def test_ranks_equal_jax_and_numpy_oracle(hins, chunk_users):
    thin, jhin = hins
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((thin.num_nodes, 8)).astype(np.float32)
    emb_t, emb_j = torch.from_numpy(emb), jnp.asarray(emb)
    tables = tsamp.build_device_tables(thin, "cpu")
    assert tables.test_users.shape[0] % 7 != 0

    def score(u, i):
        return torch.sum(emb_t[u.long()] * emb_t[i.long()], dim=-1)

    out = evaluate_full_ranking(score, tables, chunk_users=chunk_users)
    ranks = out["ranks"].numpy()
    assert out["ranks"].dtype == torch.int32 and out["HR"].shape == (16,)

    jout = j_full(lambda u, i: jnp.sum(emb_j[u] * emb_j[i], axis=-1),
                  jsamp.build_device_tables(jhin), chunk_users=16)
    np.testing.assert_array_equal(ranks, np.asarray(jout["ranks"]))
    # the means of equal per-user values, summed in another order
    np.testing.assert_allclose(out["HR"].numpy(), np.asarray(jout["HR"]), rtol=1e-6)
    np.testing.assert_allclose(out["NDCG"].numpy(), np.asarray(jout["NDCG"]), rtol=1e-6)

    seen_by_user = {}
    for a, b in thin.train_pos:
        seen_by_user.setdefault(int(a), set()).add(int(b))
    item_ids = np.arange(thin.num_items) + thin.item_acc
    for k in range(thin.num_users):
        u, p = int(tables.test_users[k]), int(tables.test_items[k])
        unseen = [i for i in item_ids if i not in seen_by_user.get(u, set()) and i != p]
        pos_s = float(emb[u] @ emb[p])
        assert ranks[k] == sum(1 for i in unseen if float(emb[u] @ emb[i]) > pos_s), k


def test_trainer_evaluate_full_on_cpu(hins):
    thin, _ = hins
    cfg = PEAConfig(conv="gat", num_nodes=thin.num_nodes, meta_path_steps=(2,) * 9,
                    emb_dim=8, hidden_size=8, repr_dim=4, entity_aware=True)
    trainer = PEATrainer(thin, cfg, TrainConfig(batch_size=512), device="cpu")
    out = trainer.evaluate_full(trainer.init(0))
    hr = out["HR"].numpy()
    assert hr.shape == (16,) and np.isfinite(hr).all()
    assert np.all(np.diff(hr) >= 0)
    assert out["ranks"].shape == (thin.num_users,) and int(out["ranks"].min()) >= 0
