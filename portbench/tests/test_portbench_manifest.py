"""BENCHMARK.json against its format's rules, and every name in it found
by the harness: configuration, traffic, limits and metric readers."""

import json
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert MAN["paths"] == ["portbench"]
    assert not any(w.startswith("/") or ".." in w for w in MAN["command"])


def test_names_and_units():
    names = [m["name"] for m in MAN["configs"] + MAN["workloads"]]
    names += [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [w["config"] for w in MAN["workloads"]] + [w["traffic"] for w in MAN["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_configuration_has_a_cell():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


def test_per_layer_metrics_move_what_their_cells_report():
    for m in MAN["per_layer"]:
        moves = next(e for e in MAN["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert "workloads" not in moves or w in moves["workloads"], (m["name"], w)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(MAN, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(MAN, w["name"], True)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_files_of_each_cell(cell):
    w = next(x for x in MAN["workloads"] if x["name"] == cell)
    traffic = harness.load_json(os.path.join(harness.HERE, "traffic", f"{w['traffic']}.json"))
    harness.loop(traffic["loop"])
    with open(os.path.join(harness.HERE, "limits", f"{cell}.json")) as f:
        assert json.load(f)["limits"]
    for m in harness.cell_metrics(MAN, cell, False) + harness.cell_metrics(MAN, cell, True):
        assert callable(harness.reader(m["name"]))


def test_configuration_files_state_their_cuts():
    for c in MAN["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"] == []
        assert conf["name"] == c["name"] and "assumed" in conf


def test_four_chip_cells_within_their_share():
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)
