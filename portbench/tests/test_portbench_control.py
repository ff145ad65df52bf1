"""The control on the card: the reference at TF32 in the program's place
reads above a limit of the cell in every seed, the program below every
limit, at the cell's own size (portbench/study/limits.py, three seeds;
about a minute a cell with the dataset cached)."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(BENCH, "study"))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["peagat-ml25m.train", "peagat-ml25m.eval"])
def test_the_control_fails_and_the_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import limits

    from pbcore import spec

    lim = spec.load_cell(cell).limits
    for row in limits.study(cell, [7, 8, 9], [7, 8, 9]):
        assert all(v <= lim[k] for k, v in row["program"].items()), row
        assert any(v > lim[k] for k, v in row["control"].items()), row
