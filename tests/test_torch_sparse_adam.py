"""The port's SparseAdam (train/optim.py) against the JAX package's optax
chain ``make_optimizer("sparseadam", lr, weight_decay)`` on dense
gradients: 3 steps over a tree whose rows go untouched in some steps
(a whole zero gradient row of a 2-D leaf, a zero entry of a 1-D leaf, a
leaf with no gradient at all), held to 1e-6; ``weight_decay`` is ignored
as the JAX chain ignores it, an untouched row stays bitwise as it was
(no momentum tail), and the bias correction counts every step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graph_recsys_benchmark_tpu.train import optim as joptim
from graph_recsys_benchmark_tpu_torch.train import optim as toptim

SHAPES = {"x": (7, 4), "w": (3, 2, 5), "b": (6,)}


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_sparse_adam_matches_optax(weight_decay):
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]
    for step, g in enumerate(grads):
        g["x"][step] = 0.0  # row `step` untouched this step
        g["x"][5] = 0.0  # row 5 never touched
        g["w"][step % 3] = 0.0
        g["b"][step] = 0.0
    tx = joptim.make_optimizer("sparseadam", 1e-2, weight_decay)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    extra = torch.nn.Parameter(torch.ones(3))  # never gets a gradient
    topt = toptim.make_optimizer("sparseadam", 1e-2, weight_decay)(
        list(tp.values()) + [extra])
    assert isinstance(topt, toptim.SparseAdam)
    for step, g in enumerate(grads):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        before = tp["x"].detach().clone()
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k].copy())
        topt.step()
        # the untouched rows are bitwise as they were
        assert torch.equal(tp["x"].detach()[step], before[step])
        assert torch.equal(tp["x"].detach()[5], before[5])
        for k, t in tp.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=1e-6, err_msg=f"step {step} {k}")
    assert torch.equal(extra.detach(), torch.ones(3))
    np.testing.assert_array_equal(tp["x"].detach().numpy()[5], params["x"][5])
    assert all(s["step"] == 3 for s in topt.state.values())
    assert int(state[0].count) == 3
