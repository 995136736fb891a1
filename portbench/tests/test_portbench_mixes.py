"""Each cell's loop on the CPU at small sizes, through the harness's
test-only entry (`harness.run_cell` with overrides): a run, traced and
not, reports its metrics and comes out correct."""

import pytest
import torch

from portbench import harness
from portbench.tests import mini

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell):
    r = mini.run(cell)
    assert r["correct"], r["checked"]
    want = {m["name"] for m in harness.cell_metrics(harness.manifest(), cell, False)}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checked"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(cell):
    r = mini.run(cell, trace=True)
    assert r["correct"]
    assert "busy_s" in r["device"] and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no device share can be read; host metrics can
    names = set(r["metrics"])
    assert not any(n.endswith("_roofline") or n.startswith("idle.") for n in names)
    assert any(n.startswith("mfu.") for n in names)


def test_same_seed_same_answers():
    """A window of one unit: the same seed draws the same inputs, weights
    and samples."""
    a = mini.run("eval-bert-64clip-bf16", seconds=0)
    b = mini.run("eval-bert-64clip-bf16", seconds=0)
    assert a["checked"] == b["checked"] and a["attempted"] == b["attempted"]
    c = mini.run("eval-bert-64clip-bf16", seed=mini.SEED + 1, seconds=0)
    assert c["checked"] != a["checked"]
