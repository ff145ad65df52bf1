"""The frozen counts against hand counts on a toy graph."""

import numpy as np

from pbcore import counts, peaks

MODEL = dict(emb_dim=4, hidden_size=3, repr_dim=2, num_heads=1, channel_aggr="att",
             entity_aware=False, table_bound=0.1)


def toy():
    # 5 nodes; relation r: 4 edges, one a self-loop (left out); s: 2 edges
    edge_index = {"r": np.array([[0, 1, 2, 3], [1, 2, 2, 4]]), "s": np.array([[4, 0], [0, 3]])}
    metapaths = [["r", "s"], ["r", "rev:s"], ["s", "s"]]
    return edge_index, metapaths


def test_groups_and_loop_free_edges():
    ei, mp = toy()
    groups = {(g.step, g.relation): g for g in counts.graph_groups(ei, mp, stream_min_edges=3)}
    assert groups[(0, "r")].edges == 3 and groups[(0, "r")].channels == (0, 1)
    assert groups[(0, "r")].stream and not groups[(1, "s")].stream
    assert groups[(1, "s")].channels == (0, 2) and groups[(1, "rev:s")].channels == (1,)


def test_attention_counts_by_hand():
    # E = 3, N = 5, C = 2, kz = 3
    f, b = counts.attention(3, 5, 2, 3, "fwd")
    assert f == 2 * ((3 + 5) * (2 * 3 + 5) + 5 * 3)
    assert b == 4 * 2 * 5 * (3 + 2) + 8 * 3 + 4 * 2 * 5 * 3
    f, b = counts.attention(3, 5, 2, 3, "bwd")
    assert f == 2 * (3 + 5) * (4 * 3 + 10)
    assert b == 4 * 2 * 5 * (2 * 3 + 4) + 8 * 3 + 4 * 2 * 5 * (3 + 2)


def test_bound_and_step_flops_by_hand():
    ei, mp = toy()
    groups = counts.graph_groups(ei, mp, stream_min_edges=3)
    steps = (2, 2, 2)
    # stream: only step 0 over r (C 2, kz 3)
    want = sum(max(b / peaks.HBM_BYTES_PER_S, f / peaks.F32_FLOPS)
               for f, b in (counts.attention(3, 5, 2, 3, d) for d in ("fwd", "bwd")))
    assert counts.attention_bound_s(groups, MODEL, 5, steps, ("fwd", "bwd"), True) == want
    n = 5
    conv0 = 2 * n * 4 * 3 + 4 * n * 3 + n * 3 + n * 3  # h W, a's, bias, ReLU
    conv1 = 2 * n * 3 * 2 + 4 * n * 2 + n * 2
    fwd = 3 * conv0 + 3 * conv1
    fwd += counts.attention(3, n, 2, 3, "fwd")[0] + counts.attention(2, n, 1, 3, "fwd")[0]
    fwd += counts.attention(2, n, 2, 2, "fwd")[0] + counts.attention(2, n, 1, 2, "fwd")[0]
    fwd += n * 3 * (4 * 2 + 4)
    assert counts.forward_flops(groups, MODEL, n, 3, steps) == fwd
    train = dict(batch_size=7, num_neg_candidates=99)
    params = (128 * 4 + 3 * (4 * 3 + 1 * 1 * 6 + 3 + 3 * 2 + 1 * 1 * 4 + 2)
              + 1 * 3 * 2 + 4 * 2 + 2 + 2 * 1 + 1)
    assert counts.parameter_count(MODEL, n, steps) == params
    scorer = 2 * 7 * (2 * 4 * 2 + 2 * 2 + 2 * 2 + 1)
    assert counts.train_step_flops(groups, MODEL, train, n, steps) == (
        3 * (fwd + scorer + 8 * 7) + 12 * params)
    pairs = 6 * 100
    assert counts.eval_pass_flops(groups, MODEL, train, n, steps, 6) == (
        fwd + pairs * (2 * 4 * 2 + 2 * 2 + 2 * 2 + 1) + 3 * pairs)
