"""The readers of the program's own spans on each loop's mini CPU run: the
window's root calls line up one for one with the harness's `host_s`, the
metrics of spans and counters are read, and a window that does not line
up, or a program that records no spans, reads nothing."""

import dataclasses

import pytest
import torch

from portbench import harness, spans as S
from portbench.tests import mini

ROOTS = {"serve": ("engine.step",), "eval": ("dcnet.eval_clip", "decode.best"),
         "train": ("train.step",)}
CELLS = {"serve": "serve-bilstm-120s-bf16", "eval": "eval-bert-64clip-bf16",
         "train": "train-bilstm-32clip-fp32"}
NEW = {"serve": ["host_ms.serve.extract", "host_ms.serve.corr", "host_ms.serve.trunk",
                 "host_ms.serve.tail"],
       "eval": ["host_ms.eval.extract", "host_ms.eval.language", "host_ms.eval.corr",
                "host_ms.eval.trunk"],
       "train": ["host_syncs.train"]}     # the device_ms.train.* read CUDA events


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def traced(loop, monkeypatch, **kw):
    """A traced mini run of the loop's cell and the Reading its readers got."""
    got = []
    real = harness.reader

    def keep(name):
        read = real(name)
        return lambda r: got.append(r) or read(r)

    monkeypatch.setattr(harness, "reader", keep)
    out = mini.run(CELLS[loop], seconds=0.3, trace=True, **kw)
    return out, got[0]


@pytest.mark.parametrize("loop", sorted(ROOTS))
def test_root_calls_line_up_with_the_window(loop, monkeypatch):
    from dcnet_tpu_torch.utils import profiling

    out, r = traced(loop, monkeypatch)
    assert out["correct"] and r.units >= 2
    assert S.window(r, ROOTS[loop]) is profiling
    calls = [profiling.root_calls(name, r.units) for name in ROOTS[loop]]
    for i, host in enumerate(r.host_s):
        assert sum(c[i].host_ms for c in calls) / 1e3 <= host
    for name in NEW[loop]:
        assert out["metrics"][name]["value"] >= 0, name
    if loop == "serve":     # the four stages hold nearly all of the tick
        share = sum(out["metrics"][n]["value"] for n in NEW[loop]) / (
            1e3 * sum(r.host_s) / r.units)
        assert 0.9 <= share <= 1.0
    assert not any(n.startswith("device_ms.") for n in out["metrics"])   # no card here

    # a window that does not line up with the calls reads nothing
    shifted = dataclasses.replace(r, host_s=[h * 0.9 for h in r.host_s])
    longer = dataclasses.replace(r, host_s=[h * 1.05 for h in r.host_s])
    fewer_calls = dataclasses.replace(r, units=r.units + 1, host_s=r.host_s + [1.0])
    for bad in (shifted, longer, fewer_calls):
        assert S.window(bad, ROOTS[loop]) is None
        assert all(harness.reader(n)(bad) is None for n in NEW[loop])


def test_a_program_that_records_no_spans_reads_nothing(monkeypatch):
    from dcnet_tpu_torch.utils import profiling

    profiling.SPANS.clear()
    old = profiling.record_spans(False)
    try:
        out, r = traced("serve", monkeypatch)
    finally:
        profiling.record_spans(old)
    assert out["correct"] and not any(n.startswith("host_ms.") for n in out["metrics"])
    monkeypatch.setattr(S, "_profiling", lambda: None)     # a program without spans
    assert harness.reader("host_ms.serve.extract")(r) is None
