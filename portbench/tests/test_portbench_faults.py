"""The comparison catches a broken timed path: each test skips the look
for a card, drives the rest of a run at small sizes with the program
broken underneath (`portbench.faults`), and sees `correct` come out false
under the cells' own limits. One fault each that the cell can have: an
answer altered where it is produced (a box moved; where the cell compares
the choice, the runner-up candidate chosen by the decode or the fusion),
a step that returns its state
unchanged, half of the batch left out (the mean taken over the rest).
One chip: there is no exchange between chips to leave out."""

import os

import pytest
import torch

from portbench import compare as C
from portbench import faults, harness
from portbench.tests import mini

SERVE = ["serve-bilstm-120s-bf16", "serve-bilstm-120s-int8"]
EVAL = "eval-bert-64clip-bf16"
TRAIN = "train-bilstm-32clip-fp32"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def judges_choice(cell: str) -> bool:
    """Whether the cell compares the choice (the runner-up faults)."""
    return "choice_gap_mean" in C.limits_for(cell)


CASES = [(c, f) for c in SERVE for f in ("serve_answer", "serve_stuck")] + [
    (c, f) for c in SERVE + [EVAL] if judges_choice(c)
    for f in (("eval_second",) if c == EVAL else ("serve_second_raw", "serve_second_fused"))] + [
    (EVAL, "eval_answer"), (EVAL, "eval_half"),
    (TRAIN, "train_stuck"), (TRAIN, "train_half"), (TRAIN, "train_answer")]


def traffic(cell: str) -> dict:
    """Four clips, and the bf16 cells' program in fp32: at widths of 16 the
    bf16 rounding reads close to the cells' limits, and these tests are
    about the faults."""
    t = {"clips": 4}
    if cell != TRAIN and "int8" not in cell:
        prog = harness.load_json(os.path.join(harness.HERE, "traffic",
                                              mini.traffic_name(cell) + ".json"))["program"]
        t["program"] = dict(prog, compute_dtype="float32")
    return t


@pytest.mark.parametrize("cell", SERVE + [EVAL, TRAIN])
def test_sound_run_is_correct(cell):
    assert mini.run(cell, traffic=traffic(cell))["correct"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault):
    with faults.FAULTS[fault]():
        r = mini.run(cell, traffic=traffic(cell))
    assert not r["correct"], r["checked"]
    if fault == "train_stuck":
        assert r["checked"]["change_rel"]["value"] == pytest.approx(1.0)
