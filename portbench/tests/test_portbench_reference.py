"""The reference on the CPU: against a dense form of the same layer,
against itself, and the pieces of the eval check by hand."""

import math

import numpy as np
import pytest
import torch

from pbcore import reference as ref


def dense_gat(h, w, att, b, src, dst, n):
    """GATConv as a dense masked softmax over an adjacency with loops."""
    z = h[:n] @ w
    d = z.shape[1]
    logit = z @ att[0, 0, :d][:, None] + (z @ att[0, 0, d:][:, None]).T  # [dst, src]
    logit = torch.nn.functional.leaky_relu(logit, 0.2)
    count = torch.zeros(n, n, dtype=h.dtype)
    count.index_put_((dst, src), torch.ones_like(dst, dtype=h.dtype), accumulate=True)
    e = torch.exp(logit - logit.max(dim=1, keepdim=True).values) * count
    alpha = e / (e.sum(dim=1, keepdim=True) + 1e-16)
    return alpha @ z + b


def test_gat_conv_matches_dense_form():
    g = torch.Generator().manual_seed(0)
    n, din, dout = 9, 5, 4
    h = torch.randn(n + 3, din, generator=g, dtype=torch.float64)
    w = torch.randn(din, dout, generator=g, dtype=torch.float64)
    att = torch.randn(1, 1, 2 * dout, generator=g, dtype=torch.float64)
    b = torch.randn(dout, generator=g, dtype=torch.float64)
    # a multi-edge, a self-loop that is dropped, an isolated node
    ei = {"r": np.array([[0, 1, 1, 2, 3, 3, 5], [1, 2, 2, 2, 4, 0, 7]])}
    (src, dst), = ref.build_graphs(ei, [["r"]], n, "cpu")[0]
    got = ref.gat_conv(ref.Precision(), h, w, att, b, src, dst, n, 1)
    torch.testing.assert_close(got, dense_gat(h, w, att, b, src, dst, n))
    assert int((src == dst).sum()) == n  # one loop a node


def test_training_steps_repeat_exactly():
    g = torch.Generator().manual_seed(1)
    model = dict(emb_dim=6, hidden_size=5, repr_dim=3, num_heads=1, channel_aggr="att",
                 entity_aware=False, entity_aware_coff=0.1, table_bound=0.5)
    n = 12
    ei = {"r": np.array([[0, 1, 2, 3, 8, 9], [4, 5, 6, 7, 10, 11]])}
    metapaths = [["r", "rev:r"], ["rev:r", "r"]]
    leaves = {}
    for name, shape, bound in ref.leaf_table(model, n, (2, 2)):
        leaves[name] = (torch.rand(shape, generator=g) * 2 - 1) * bound
    graphs = ref.build_graphs(ei, metapaths, n, "cpu")
    batch = torch.tensor([[0, 4, 5], [1, 5, 6], [2, 7, 4]])
    mask = torch.tensor([1.0, 1.0, 0.0])
    a = ref.train_steps(leaves, graphs, model, n, [batch] * 3, [mask] * 3, 1e-2, 1e-3,
                        ref.Precision(), "cpu")
    b = ref.train_steps(leaves, graphs, model, n, [batch] * 3, [mask] * 3, 1e-2, 1e-3,
                        ref.Precision(), "cpu")
    assert a[0] == b[0]
    for k in leaves:
        assert torch.equal(a[3][k], b[3][k]) and not torch.equal(a[3][k], leaves[k])
    # the masked row does not count
    c = ref.loss({k: v.clone() for k, v in leaves.items()}, graphs, model, n, batch[:2],
                 mask[:2], ref.Precision())
    assert math.isclose(a[0][0], float(c), rel_tol=1e-6)


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -12), 0.0])
    got = ref.tf32_round(x)
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -1.0, 0.0]
    a = torch.randn(8, 8, requires_grad=True)
    out = ref.Precision("tf32").mm(a, torch.eye(8))
    out.sum().backward()
    assert torch.equal(a.grad, torch.ones(8, 8))


def test_rank_gap_and_metrics():
    s_pos = torch.tensor([0.0, 0.0])
    s_neg = torch.tensor([[0.5, -0.2, 0.1, -1.0], [1e-9, -0.3, 0.2, 0.4]])
    exact = (s_neg > s_pos[:, None]).sum(1)
    assert exact.tolist() == [2, 3]
    assert ref.rank_gap(exact, s_pos, s_neg) == 0.0
    scale = float((s_neg - s_pos[:, None]).abs().median())
    # user 1's tie at 1e-9 read the other way
    assert ref.rank_gap(torch.tensor([2, 2]), s_pos, s_neg) == pytest.approx(1e-9 / scale)
    # a rank off by one past a clear gap
    assert ref.rank_gap(torch.tensor([1, 3]), s_pos, s_neg) == pytest.approx(0.1 / scale)
    # users ranked 0, 4 and 12 among 99 negatives, one tie with the last
    neg = torch.zeros(3, 99)
    neg[1, :4] = 1.0
    neg[2, :12] = 1.0
    neg[2, 12] = 0.5  # tied: not above, not below
    m = ref.metrics_from_scores(torch.tensor([0.5, 0.5, 0.5]), neg)
    assert m[0] == pytest.approx(2 / 3) and m[16] == pytest.approx((1 + 1 / math.log2(6)) / 3)
    assert m[-1] == pytest.approx((99 + 95 + 86) / 3 / 99)


def test_negative_and_batch_rules():
    keys = torch.tensor([0 * 10 + 3, 1 * 10 + 4])
    neg = torch.tensor([[103, 105], [104, 99]])  # user 0 drew its item 3; user 1 a non-item
    assert ref.negative_violations(neg, torch.tensor([0, 1]), keys, 100, 10) == 3
    arrays = dict(train_pos=torch.tensor([[0, 100], [1, 101]]), item_lo=100, num_items=10,
                  user_lo=0, item_feat=torch.tensor([[20, 21]] * 10),
                  item_feat_counts=torch.tensor([2] + [0] * 9),
                  user_feat=torch.tensor([[30]] * 2), user_feat_counts=torch.tensor([1, 0]),
                  ent_lo=torch.tensor([0] * 20 + [20, 20] + [0] * 8 + [30, 30]),
                  ent_hi=torch.tensor([0] * 20 + [25, 25] + [0] * 8 + [35, 35]))
    rows = torch.tensor([0, 3])  # interactions 0 and 1
    good = torch.tensor([[0, 100, 105, 21, 24, 1, 30, 31, 1],
                         [1, 101, 109, 0, 0, 0, 0, 0, 0]])
    assert ref.batch_violations(good, rows, arrays, 2, "random", True) == 0
    bad = good.clone()
    bad[0, 4] = 25  # the corrupted entity past its type's range
    bad[1, 2] = 110  # a negative past the items
    assert ref.batch_violations(bad, rows, arrays, 2, "random", True) == 2
