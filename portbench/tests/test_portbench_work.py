"""The yardstick's arithmetic: the backbone's operations, against the
figure darknet prints for yolov3.cfg and against the program's own list of
live layers, and the kernels' least times against values worked out by
hand."""

import math

import pytest

from portbench.reference.geometry import load_geometry, live, yolov3_layers
from portbench.work import dcnet as D
from portbench.work.peaks import PEAK_BYTES, PEAK_FLOPS

G = load_geometry("portbench/configs/dcnet-vid-bilstm.json")


def test_yolov3_at_416_is_darknets_figure():
    convs = D.backbone_convs(G, live_only=False, size=416)
    assert len(convs) == 75
    assert D.backbone_flops(G, live_only=False, size=416) / 1e9 == pytest.approx(65.864, abs=5e-4)


def test_live_convs_at_256():
    assert len(D.backbone_convs(G)) == 68
    assert D.backbone_flops(G) / 1e9 == pytest.approx(22.83, abs=5e-3)


def test_live_layers_match_the_program():
    from dcnet_tpu_torch.models.darknet import yolov3_layer_defs
    from dcnet_tpu_torch.ops.quant import live_layers
    assert live(yolov3_layers()) == live_layers(yolov3_layer_defs())


def test_k1_bound_by_hand():
    # B=8, P=1024, C=512, bf16: 4 B P^2 C = 17.18 GFLOP at 989 TFLOP/s
    ops = 4 * 8 * 1024 ** 2 * 512
    assert D.attend_seconds(8, 1024, 512, "bf16") == pytest.approx(ops / 989e12)
    assert ops / 989e12 * 1e3 == pytest.approx(0.01737, rel=1e-3)   # PERF.md's K1 bound


def test_k3_bound_by_hand():
    one = 2.0 * 16 * 1024 ** 2 * 512
    assert D.attend_bwd_seconds(16, 1024, 512, "fp32") == pytest.approx(5 * one / (495e12 / 3))
    want = 2 * one / 989e12 + 3 * one / (989e12 / 3)
    assert D.attend_bwd_seconds(16, 1024, 512, "bf16") == pytest.approx(want)


def test_k4_bound_by_hand():
    b, s, p, c = 120, 5, 1024, 512
    ops = 4 * b * (s - 1) * p * p * c
    assert D.ring_seconds(b, s, p, c, "bf16") == pytest.approx(ops / 989e12)
    # int8 rings: half the products at the int8 peak, half at bf16's
    assert D.ring_seconds(b, s, p, c, "int8") == pytest.approx(ops / 2 / 1979e12 + ops / 2 / 989e12)
    # a bytes-bound ring: P = 64
    nbytes = b * 64 * c * (s * 2 + (s - 1) * 2)
    assert D.ring_seconds(b, s, 64, c, "bf16") == pytest.approx(
        max(4 * b * (s - 1) * 64 ** 2 * c / 989e12, nbytes / PEAK_BYTES))


def test_k6_bound_by_hand():
    # 3x3 256 -> 512, stride 1, pad 1, 16 x 16, 8 frames, bf16 in and out
    ops = 2.0 * 8 * 16 * 16 * 9 * 256 * 512
    nbytes = 8 * 16 * 16 * 256 * 2 + 512 * 9 * 256 + 16 * 512 + 8 * 16 * 16 * 512 * 2
    got = D.conv_s8_seconds(8, 3, 1, 1, 256, 512, 16, "bf16", "bf16")
    assert got == pytest.approx(max(ops / 1979e12, nbytes / 3.35e12))


def test_peaks():
    assert PEAK_FLOPS["bf16"] == 989e12 and PEAK_FLOPS["int8"] == 1979e12
    assert PEAK_FLOPS["fp32"] == pytest.approx(165e12)


def test_unit_work_per_item():
    import json
    t = json.load(open("portbench/traffic/serve-120s-bf16.json"))
    w = D.unit_work(G, t)
    per = sum(w["ops"].values()) / t["streams"]
    assert per / 1e9 == pytest.approx(46.95, abs=0.01)
    assert math.isclose(D.least_unit_seconds(w), sum(w["ops"].values()) / 989e12)
