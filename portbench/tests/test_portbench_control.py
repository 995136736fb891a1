"""The controls: the reference put in the program's place, one precision
step below the cell's (fp8 for bf16, int4 for int8, TF32 for fp32 with
TF32 off), must come out as not correct under the cell's limits, at the
cell's own size, on the card (marked `cuda`, skipped elsewhere):

    python3 -m pytest -p no:cacheprovider portbench/tests -m cuda

The small sizes of the CPU tests (widths of 16) do not stand for the
cells' numbers, so the controls are not held there."""

import pytest
import torch

from portbench import compare as C
from portbench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def control_of(cell: str) -> str:
    return harness.load_json(f"{harness.HERE}/limits/{cell}.json")["control"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    c = control_of(cell)
    r = harness.run_cell(cell, 2 ** 31 + 11, 2.0, False, controls=(c,))
    assert r["correct"], r["checked"]
    assert not C.judge(r["controls"][c], C.limits_for(cell)), r["controls"]
