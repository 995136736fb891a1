"""Rates, tails and shares over the whole window: a stall planted in a
synthetic window moves both the rate and the tail; the shares read
nothing where there is nothing to read."""

import pytest

from portbench import harness, readers as R


def reading(unit_s, trace=None, work=None, loop="serve", items=120):
    return harness.Reading(traffic={"loop": loop}, setup_s=1.0,
                           units=len(unit_s), items=items, window_s=sum(unit_s), unit_s=unit_s,
                           host_s=[0.001] * len(unit_s),
                           work=work or {"ops": {"bf16": 989e12 * 0.01}, "kernels": {"k4": 0.002}},
                           trace=trace)


def test_rate_and_tail_over_all_units():
    steady = [0.04] * 400
    r = reading(steady)
    assert R.rate(r) == pytest.approx(120 / 0.04)
    assert R.p95_ms(r) == pytest.approx(40.0)


def test_a_planted_stall_moves_rate_and_tail():
    base = [0.04] * 400
    stalled = base[:]
    for i in range(0, 400, 15):      # 27 of 400 units stall: more than 5%
        stalled[i] = 0.2
    a, b = reading(base), reading(stalled)
    assert R.rate(b) < 0.8 * R.rate(a)
    assert R.p95_ms(b) == pytest.approx(200.0)
    assert R.p95_ms(a) == pytest.approx(40.0)


def test_mfu():
    r = reading([0.04] * 10)
    assert R.mfu(r) == pytest.approx(100 * 0.01 / 0.04)


def test_shares_need_a_trace():
    r = reading([0.04] * 10)
    assert R.roofline(r, "k4") is None and R.idle(r) is None
    t = {"busy_s": 0.3, "units": 10, "kernel_s": {"k4": 0.04}}
    r = reading([0.04] * 10, trace=t)
    assert R.roofline(r, "k4") == pytest.approx(100 * 0.002 / 0.004)
    assert R.idle(r) == pytest.approx(100 * (1 - 0.03 / 0.04))
    assert R.roofline(r, "k6") is None          # a kernel the cell does not run
    t = dict(t, kernel_s={})
    assert R.roofline(reading([0.04] * 10, trace=t), "k4") is None


def test_readers_of_other_loops_read_nothing():
    r = reading([0.04] * 10, loop="eval")
    assert harness.reader("predictions_per_s")(r) is None
    assert harness.reader("clips_per_s")(r) == pytest.approx(120 / 0.04)


def test_trace_events():
    from portbench import trace
    ev = [{"ph": "X", "cat": "kernel", "ts": 0, "dur": 10, "name": "void ring_wgmma_kernel<1>()"},
          {"ph": "X", "cat": "kernel", "ts": 5, "dur": 10, "name": "cudnn_conv"},
          {"ph": "X", "cat": "kernel", "ts": 40, "dur": 10, "name": "conv_tma_kernel"},
          {"ph": "X", "cat": "cpu_op", "ts": 10, "dur": 40, "name": "aten::cat"},
          {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 100, "name": "step"}]
    out = trace.read_events(ev)
    assert out["busy_s"] == pytest.approx(25e-6)
    assert out["kernel_s"] == {"k4": pytest.approx(10e-6), "k6": pytest.approx(10e-6)}
    assert out["idle_gaps"] == [["aten::cat", pytest.approx(25e-6)]]
