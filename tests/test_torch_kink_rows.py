"""chip_smoke.kink_rows: which batch rows a gradient comparison leaves out.

Two runs of one training step (the card's and a CPU copy's) can put the
pair scorer's ReLU input (fc1 of models.pea.pea_predict) on different
sides of 0 when it sits within their rounding difference of it; that row
then moves every gradient leaf by its whole share of the batch.
kink_rows flags such rows from the two runs' own pre-activations and
fails when more than KINK_ROW_SHARE of a batch would be flagged.  These
tests give it hand-made representations on the CPU (no card needed):
identical runs flag nothing, one row whose input changes sign between the
runs is flagged alone, and runs that disagree everywhere fail.
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke

ROWS, DIM, HIDDEN = 200, 4, 8


def _run(rep, fc1):
    model = types.SimpleNamespace(x=torch.zeros(1), fc1=fc1)
    return model, lambda m: rep


def _case(seed=0):
    """A representation, fc1, and a batch whose row r holds users r, items
    ROWS + r (positive) and 2 ROWS + r (negative), so each node is one
    row's alone."""
    rng = np.random.default_rng(seed)
    rep = torch.from_numpy(rng.standard_normal((3 * ROWS, DIM)).astype(np.float32))
    fc1 = {"w": torch.from_numpy(rng.standard_normal((2 * DIM, HIDDEN)).astype(np.float32)),
           "b": torch.from_numpy(rng.standard_normal(HIDDEN).astype(np.float32))}
    r = torch.arange(ROWS)
    batch = torch.stack([r, ROWS + r, 2 * ROWS + r], dim=1)
    return rep, fc1, batch


def _pre(rep, fc1, row, col):
    z = torch.cat([rep[row], rep[col]])
    return z @ fc1["w"] + fc1["b"]


def test_identical_runs_flag_nothing():
    rep, fc1, batch = _case()
    rows = chip_smoke.kink_rows("same", batch, _run(rep, fc1), _run(rep.clone(), fc1))
    assert rows.shape == (ROWS,) and not rows.any()


@pytest.mark.parametrize("col", [1, 2])
def test_a_sign_flip_flags_its_row_alone(col):
    rep, fc1, batch = _case(1)
    row, unit = 17, 3
    item = int(batch[row, col])
    w_item = fc1["w"][DIM:, unit]
    # move the item's representation along fc1's column so that the unit's
    # input is +1e-6 in one run and -1e-6 in the other
    pre = _pre(rep, fc1, row, item)[unit]
    a, b = rep.clone(), rep.clone()
    a[item] += (1e-6 - pre) * w_item / w_item.dot(w_item)
    b[item] += (-1e-6 - pre) * w_item / w_item.dot(w_item)
    assert _pre(a, fc1, row, item)[unit] > 0 > _pre(b, fc1, row, item)[unit]
    rows = chip_smoke.kink_rows("flip", batch, _run(a, fc1), _run(b, fc1))
    assert rows.nonzero().flatten().tolist() == [row]


def test_runs_that_disagree_everywhere_fail():
    rep, fc1, batch = _case(2)
    other = -rep  # every scorer input moves by far more than itself
    with pytest.raises(AssertionError, match="at the scorer's ReLU kink"):
        chip_smoke.kink_rows("apart", batch, _run(rep, fc1), _run(other, fc1))
