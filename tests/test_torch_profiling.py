"""The port's profiling module (`dcnet_tpu_torch/utils/profiling.py`):
`summarize_trace` on a hand-written Chrome trace (exact rows, the table by
span too), a CPU `device_trace` read back by it, the launch-count check of
`chip_smoke.py --profile` for every hand-written kernel (K1-K6), and the
program's spans and counters: nesting, the bounded ring, `record_spans`,
the mirror into a profiler's trace, `stage_ms` on hand-set records, the
spans of a served tick, an eval call and a train step of a tiny model, and
an exported tick that holds none."""

import json
import os
import re

import collections

import pytest
import torch

from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.utils import profiling

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "dcnet_tpu_torch", "csrc")


def _write_trace(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "deviceProperties": []}, f)


def test_summarize_trace_gives_the_exact_rows(tmp_path):
    ev = [
        {"ph": "X", "cat": "kernel", "name": "attend_wgmma_kernel<512>", "pid": 0,
         "tid": 7, "ts": 0, "dur": 300.0},
        {"ph": "X", "cat": "kernel", "name": "attend_wgmma_kernel<512>", "pid": 0,
         "tid": 7, "ts": 400, "dur": 200.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
         "pid": 0, "tid": 7, "ts": 700, "dur": 250.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "tid": 7,
         "ts": 990, "dur": 250.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 11, "tid": 11, "ts": 0,
         "dur": 1500.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 11, "tid": 11, "ts": 0,
         "dur": 500.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 11,
         "tid": 11, "ts": 0, "dur": 12.5},
        {"ph": "i", "cat": "cpu_instant_event", "name": "marker", "pid": 11, "ts": 3},
        {"ph": "f", "cat": "ac2g", "name": "flow", "pid": 0, "ts": 3},
    ]
    older = str(tmp_path / "run0" / "old.json")
    _write_trace(older, [{"ph": "X", "cat": "kernel", "name": "stale", "pid": 0,
                          "ts": 0, "dur": 1.0}])
    newest = str(tmp_path / "run1" / "host.pt.trace.json")
    _write_trace(newest, ev)
    os.utime(older, (1, 1))
    want = "\n".join([
        f"trace: {newest}",
        "",
        "plane 'device 0': 1 event lines",
        "  line 'kernels and copies': 1.000 ms event time, 3 distinct ops",
        "          ms      %   count  op",
        "       0.500   50.0       2  attend_wgmma_kernel<512>",
        "       0.250   25.0       1  Memcpy HtoD (Pageable -> Device)",
        "       0.250   25.0       1  Memset (Device)",
        "",
        "plane 'host': 2 event lines",
        "  line 'cpu_op': 2.000 ms event time, 2 distinct events",
        "  line 'cuda_runtime': 0.013 ms event time, 1 distinct events",
    ])
    assert profiling.summarize_trace(str(tmp_path)) == want
    assert profiling.summarize_trace(str(tmp_path), top=1).count("\n       0.") == 1
    assert profiling.summarize_trace(str(tmp_path / "none")).startswith("(no Chrome trace")


def test_device_trace_on_the_cpu_writes_a_trace_that_summarize_trace_reads(tmp_path):
    with profiling.device_trace(str(tmp_path), "cpu", "steps.json"):
        with profiling.trace_annotation("step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "steps.json") as f:
        data = json.load(f)
    names = {e.get("name") for e in data["traceEvents"]}
    assert "step" in names and "aten::mm" in names
    text = profiling.summarize_trace(str(tmp_path))
    assert "plane 'host'" in text and "line 'cpu_op'" in text and "plane 'device" not in text
    with profiling.device_trace(None, "cpu") as prof:   # no file without a directory
        torch.ones(3).sum()
    assert prof.key_averages() and os.listdir(tmp_path) == ["steps.json"]


def test_every_kernel_of_the_sources_has_a_group():
    """Each __global__ function under csrc/ is named in KERNEL_GROUPS, and
    each group's keys are keys of kernels.LAUNCHES."""
    found = set()
    for name in os.listdir(CSRC):
        with open(os.path.join(CSRC, name)) as f:
            src = f.read()
        found |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                                r"(\w+)\s*\(", src))
    named = {fn for _, _, fns in profiling.KERNEL_GROUPS for fn in fns}
    assert found == named
    assert all(k in kernels.LAUNCHES for _, keys, _ in profiling.KERNEL_GROUPS for k in keys)
    assert {k for _, keys, _ in profiling.KERNEL_GROUPS for k in keys} == set(kernels.LAUNCHES)


def _counted(**over):
    counted = dict.fromkeys(kernels.LAUNCHES, 0)
    counted.update(over)
    return counted


ROWS = [  # (device us, demangled name, calls) as key_averages gives them
    (45.7, "void (anonymous namespace)::attend_wgmma_kernel<512>(CUtensorMap, "
           "CUtensorMap, __nv_bfloat16*, __nv_bfloat16*, int, int, int, float)", 12),
    (177.0, "void (anonymous namespace)::attend_tf32_kernel(float const*, float const*, "
            "float*, float*, int, int, int, int, long long, long long, float)", 3),
    (300.0, "void (anonymous namespace)::bwd_dq_kernel<float>(float const*)", 6),
    (290.0, "void (anonymous namespace)::bwd_dkv_kernel<float>(float const*)", 6),
    (230.0, "void (anonymous namespace)::ring_s8_kernel<512>(CUtensorMap, __nv_bfloat16*)", 3),
    (20.0, "void (anonymous namespace)::factor_kernel<float, 16>(float const*)", 2),
    (3.0, "void (anonymous namespace)::expand_kernel<float, 8>(float const*)", 2),
    (500.0, "void (anonymous namespace)::conv_tma_kernel<128>(Maps, Geo, Epilogue)", 89),
    (90.0, "void (anonymous namespace)::halo::conv_halo_kernel<float, 32>(CUtensorMap)", 6),
    (40.0, "void quant_pass_kernel<__nv_bfloat16>(__nv_bfloat16 const*)", 89),
    (70.0, "void cutlass::Kernel<cutlass_80_tensorop_bf16_s16816gemm>(Params)", 9),
    (9.0, "void at::native::vectorized_elementwise_kernel<4>(int, float)", 40),
]
COUNTED = _counted(coattn_attend=12, coattn_pair=3, coattn_attend_bwd=6, coattn_ring=3,
                   loc_gram=2, conv_s8=89, conv_s8_halo=6, conv_s8_quant=89)


def test_profile_counts_hold_k1_to_k6_against_the_counters():
    res = profiling.profile_counts(ROWS, COUNTED)
    assert res["agree"], res
    assert res["by_kernel_name"]["coattn_attend+coattn_pair"] == 15    # K1 + K2
    assert res["by_kernel_name"]["coattn_attend_bwd:dq"] == 6          # a grid a K3 call
    assert res["ms_by_kernel_name"]["loc_gram:factor"] == 0.02
    assert profiling.kernel_group("void at::native::reduce_kernel<512, 1>()") is None
    assert profiling.kernel_group("void my_attend_kernel<float>()") is None


@pytest.mark.parametrize("fault", [
    "k2_counted_once_more", "k3_dkv_grid_lost", "k4_launch_lost", "k5_pass_lost",
    "k6_misnamed", "k1_unnamed"])
def test_profile_counts_flag_a_count_that_differs(fault):
    rows, counted = list(ROWS), dict(COUNTED)
    if fault == "k2_counted_once_more":
        counted["coattn_pair"] += 1
    elif fault == "k3_dkv_grid_lost":
        rows[3] = rows[3][:2] + (5,)
    elif fault == "k4_launch_lost":
        rows[4] = rows[4][:2] + (2,)
    elif fault == "k5_pass_lost":
        del rows[6]
    elif fault == "k6_misnamed":
        rows[8] = (90.0, "void conv_halo_kernel2<float, 32>(CUtensorMap)", 6)
    else:
        counted["coattn_attend"] += 1
    assert not profiling.profile_counts(rows, counted)["agree"]


def test_profile_call_raises_lost_trace_after_its_attempts(monkeypatch, tmp_path):
    from types import SimpleNamespace
    cuda = torch.autograd.DeviceType.CUDA
    calls = []

    def trace(fn):
        calls.append(fn)
        return ([SimpleNamespace(device_type=cuda, self_device_time_total=100.0,
                                 key="attend_kernel<float>(...)", count=11)], "table", 1.0,
                _counted(coattn_attend=12))

    monkeypatch.setattr(profiling, "trace_call", trace)
    with pytest.raises(profiling.LostTrace, match="every trace lost"):
        profiling.profile_call("fn", str(tmp_path), "k1", attempts=2)
    assert calls == ["fn", "fn"] and not os.listdir(tmp_path)


# --- the program's spans and counters ----------------------------------------


@pytest.fixture
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def ring(monkeypatch):
    """A fresh span ring, recording on."""
    fresh = collections.deque(maxlen=profiling.SPAN_RING)
    monkeypatch.setattr(profiling, "SPANS", fresh)
    old = profiling.record_spans(True)
    yield fresh
    profiling.record_spans(old)


def test_spans_nest_with_their_parents_and_roots(ring):
    cuda = torch.device("cuda")
    with profiling.trace_annotation("test.root") as root:
        with profiling.trace_annotation("test.a") as a:
            with profiling.trace_annotation("test.b") as b:
                profiling.count_sync(cuda, 2)
                profiling.count_sync(torch.device("cpu"))   # no card: no wait
        with profiling.trace_annotation("test.c") as c:
            kernels.LAUNCHES["coattn_ring"] += 1
    kernels.LAUNCHES["coattn_ring"] -= 1
    with profiling.trace_annotation("test.root") as again:
        pass
    assert list(ring) == [b, a, c, root, again]          # in the order they ended
    assert (root.parent, a.parent, b.parent, c.parent) == (None, root, a, root)
    assert {s.root for s in (root, a, b, c)} == {root} and again.root is again
    assert root.t0 <= a.t0 <= b.t0 <= b.t1 <= a.t1 <= c.t0 <= c.t1 <= root.t1
    assert root.counts == dict(dict.fromkeys(root.counts, 0), host_syncs=2, coattn_ring=1)
    assert set(root.counts) == set(profiling.COUNTERS) | set(kernels.LAUNCHES)
    assert a.counts is None and not any(s.profiled or s.events for s in ring)
    assert again.counts["host_syncs"] == 0


def test_the_ring_is_bounded(ring, monkeypatch):
    assert ring.maxlen == 65536
    small = collections.deque(maxlen=5)
    monkeypatch.setattr(profiling, "SPANS", small)
    for _ in range(4):
        with profiling.trace_annotation("test.root"):
            with profiling.trace_annotation("test.child"):
                pass
    assert len(small) == 5 and [s.name for s in small][0] == "test.root"
    # the oldest root kept lost its child to the ring: only the newest two count
    assert len(profiling.root_calls("test.root")) == 2
    assert profiling.stage_ms("test.root", "test.child", last=3) is None


def test_record_spans_off_records_nothing(ring):
    assert profiling.record_spans(False) is True
    with profiling.trace_annotation("test.root") as span:
        with profiling.trace_annotation("test.child"):
            pass
    assert profiling.record_spans(True) is False
    assert not ring and span.root is None and span.t1 == 0


def test_spans_mirror_into_a_profile_and_open_no_record_function_without_one(
        ring, tmp_path, monkeypatch):
    with profiling.device_trace(str(tmp_path), "cpu", "spans.json"):
        with profiling.trace_annotation("test.outer"):
            with profiling.trace_annotation("test.inner"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    assert [s.profiled for s in ring] == [True, True]
    with open(tmp_path / "spans.json") as f:
        events = json.load(f)["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    outer, inner = ann["test.outer"], ann["test.inner"]
    assert outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]

    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    with profiling.trace_annotation("test.outer"):
        with profiling.trace_annotation("test.inner"):
            pass
    assert [s.profiled for s in ring][2:] == [False, False]


class _Events:
    """Stands in for a span's CUDA event pair."""

    def __init__(self, ms):
        self.ms = ms

    def __getitem__(self, i):
        return self

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return self.ms


def _record(name, t0_us, t1_us, parent=None, profiled=False, device_ms=None):
    span = profiling.trace_annotation(name)
    span.parent, span.root = parent, (span if parent is None else parent.root)
    span.t0, span.t1, span.profiled = t0_us * 1000, t1_us * 1000, profiled
    span.counts = {"host_syncs": int(t0_us) % 7} if parent is None else None
    span.events = None if device_ms is None else _Events(device_ms)
    profiling.SPANS.append(span)
    return span


def test_stage_ms_on_hand_set_records_gives_exact_means(ring):
    for i, (fwd, bwd) in enumerate([(100, 50), (300, 70), (200, 90)]):
        t = 10000 * i
        root = profiling.trace_annotation("step.root")
        root.parent, root.root = None, root
        _record("step.fwd", t, t + fwd, root, device_ms=fwd / 250)
        _record("step.bwd", t + 400, t + 400 + bwd, root, device_ms=bwd / 250)
        _record("step.bwd", t + 600, t + 600 + 10, root, device_ms=10 / 250)
        root.t0, root.t1, root.counts = t * 1000, (t + 1000) * 1000, {"host_syncs": 3 + i}
        ring.append(root)
    # a profiled call and another root's spans never count
    prof = _record("step.root", 40000, 41000, profiled=True)
    _record("step.fwd", 40000, 40900, prof)
    _record("step.fwd", 50000, 50500)
    assert profiling.stage_ms("step.root", "step.fwd") == pytest.approx(0.2, abs=1e-12)
    assert profiling.stage_ms("step.root", "step.bwd", last=2) == pytest.approx(0.09, abs=1e-12)
    assert profiling.stage_ms("step.root", "step.root") == pytest.approx(1.0, abs=1e-12)
    assert profiling.stage_ms("step.root", "step.fwd", device=True) == pytest.approx(0.8)
    assert profiling.stage_ms("step.root", "step.none", last=3) == 0.0
    assert profiling.stage_ms("step.root", "step.fwd", last=4) is None   # 3 calls only
    assert profiling.stage_ms("step.root", "step.root", device=True) is None  # no events
    assert profiling.stage_ms("other.root", "step.fwd") is None
    assert [c.counts["host_syncs"] for c in profiling.root_calls("step.root", 2)] == [4, 5]
    table = profiling.stage_table("step.root")
    assert table.splitlines()[2:] == [
        "     1.000             step.root",
        "     0.200      0.800    step.fwd",
        "     0.080      0.320    step.bwd",
        "counts a call: host_syncs 4"]


def test_summarize_trace_by_span_gives_the_exact_rows(tmp_path):
    """Kernels go under the innermost program span around the runtime call
    of their correlation id (PyTorch's own annotations are no program
    span), idle gaps under the innermost span around their middle."""
    def x(cat, name, ts, dur, corr=None):
        ev = {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 1, "ts": ts, "dur": dur}
        if corr is not None:
            ev["args"] = {"correlation": corr}
        return ev

    events = [
        x("user_annotation", "train.step", 0, 1000),
        x("user_annotation", "train.forward", 0, 400),
        x("user_annotation", "train.backward", 500, 400),
        x("user_annotation", "Optimizer.step#RMSprop.step", 920, 60),
        x("gpu_user_annotation", "train.forward", 100, 200),
        x("cuda_runtime", "cudaLaunchKernel", 10, 5, 1),
        x("kernel", "fwd_kernel", 100, 200, 1),
        x("cuda_runtime", "cudaLaunchKernel", 510, 5, 2),
        x("kernel", "bwd_kernel", 550, 100, 2),
        x("cuda_runtime", "cudaLaunchKernel", 950, 5, 3),
        x("kernel", "rmsprop_kernel", 960, 20, 3),
        x("kernel", "lost_kernel", 700, 50, 4),          # no runtime call in the trace
        x("cuda_runtime", "cudaMemcpyAsync", 1200, 5, 5),
        x("gpu_memcpy", "Memcpy DtoH", 1210, 10, 5),
    ]
    out = profiling.OUTSIDE
    assert profiling.span_rows(events) == [
        ("train.forward", 200.0, 0.0, 1, 1),
        ("train.backward", 100.0, 260.0, 1, 1),      # gaps 650-700 and 750-960
        (out, 60.0, 230.0, 2, 0),                    # gap 980-1210
        ("train.step", 20.0, 250.0, 1, 1)]           # gap 300-550
    _write_trace(str(tmp_path / "spans.json"), events)
    text = profiling.summarize_trace(str(tmp_path))
    assert text.splitlines()[-6:] == [
        "by span: device ops under the innermost program span around their launching "
        "runtime call, idle gaps under the one around their middle",
        "   device ms    idle ms  launches  calls  span",
        "       0.200      0.000         1      1  train.forward",
        "       0.100      0.260         1      1  train.backward",
        f"       0.060      0.230         2      0  {out}",
        "       0.020      0.250         1      1  train.step"]
    assert profiling.span_rows([e for e in events if e["cat"] != "user_annotation"]) == []


def _tiny_model(**over):
    from dcnet_tpu_torch.config import DCNetConfig
    from dcnet_tpu_torch.models.darknet import mini_backbone_defs
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.weights import seeded_init_

    cfg = DCNetConfig(image_size=64, corpus_size=50, emb_size=16, lstm_hidden=16,
                      word_embedding_size=16, **over)
    return seeded_init_(DCNet(cfg, backbone_defs=mini_backbone_defs(), device="cpu"), seed=0)


def _tree(ring, root):
    return [s.name for s in sorted((s for s in ring if s.root is root), key=lambda s: s.t0)]


PATH_SPANS = {
    "tick": [["engine.step", "dcnet.extract", "engine.ring", "dcnet.corr", "dcnet.trunk",
              "engine.decode", "decode.best", "engine.cache", "engine.fuse"]],
    "eval": [["dcnet.eval_clip", "dcnet.extract", "dcnet.corr", "dcnet.language",
              "dcnet.trunk"], ["decode.best"]],
    "train": [["train.step", "train.forward", "dcnet.language", "dcnet.trunk",
               "train.backward", "train.optimizer"]],
}


@pytest.mark.parametrize("path", sorted(PATH_SPANS))
def test_each_hot_path_emits_its_spans_under_one_root_in_order(ring, two_threads, path):
    """One served tick, one eval call and its decode, one train step of a
    tiny model on the CPU: each root call holds its stages, in order, and
    its counts (no wait on a card here)."""
    gen = torch.Generator().manual_seed(9)
    model = _tiny_model()
    ids = torch.randint(1, 50, (2, 20), generator=gen)
    if path == "tick":
        from dcnet_tpu_torch.serving.engine import GroundingEngine
        eng = GroundingEngine(model, n_streams=2, topk=3, fuse_window=3)
        state = eng.init_state(ids)
        ring.clear()
        eng.step(state, torch.rand(2, 64, 64, 3, generator=gen))
    elif path == "eval":
        from dcnet_tpu_torch.ops.decode import decode_best
        out = model.eval_clip(torch.rand(10, 64, 64, 3, generator=gen), ids)
        decode_best(out.outbox, model.cfg)
    else:
        from dcnet_tpu_torch.train.state import create_train_state
        from dcnet_tpu_torch.train.step import train_step
        state = create_train_state(model, model.cfg)
        train_step(state, {"images": torch.rand(4, 64, 64, 3, generator=gen),
                           "word_ids": torch.randint(1, 50, (4, 20), generator=gen),
                           "bbox": torch.tensor([[4.0, 6.0, 40.0, 50.0]] * 4)})
    roots = [s for s in ring if s.parent is None]
    assert [_tree(ring, r) for r in roots] == PATH_SPANS[path]
    assert all(r.counts["host_syncs"] == 0 for r in roots)
    assert all(s.host_ms <= s.root.host_ms for s in ring)
    assert all(s.parent is None or s.parent.t0 <= s.t0 <= s.t1 <= s.parent.t1 for s in ring)


def test_the_exported_tick_holds_no_span_or_profiler_op(ring, two_threads, tmp_path):
    """`torch.export` of the tick, even while a profiler records: the
    program has no profiler op, and only the warm-up tick that runs before
    the trace records spans (the eager tick's stages, no `engine.step`:
    the export calls `GroundingEngine._tick`)."""
    from dcnet_tpu_torch.serving import export
    from dcnet_tpu_torch.serving.engine import GroundingEngine

    eng = GroundingEngine(_tiny_model(coattn_multiref=True, split_corr_conv=False),
                          n_streams=2, topk=3, fuse_window=3, int8_rings=True)
    with profiling.device_trace(None, "cpu"):
        export.export_engine(eng, str(tmp_path))
    prog = torch.export.load(os.path.join(str(tmp_path), export._STEP))
    targets = [str(n.target) for n in prog.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    roots = [s.name for s in ring if s.parent is None]
    assert [n for n in roots if n != "dcnet.language"] == [   # init_state's encoder aside
        "dcnet.extract", "engine.ring", "dcnet.corr", "dcnet.trunk", "engine.decode",
        "engine.cache", "engine.fuse"]
