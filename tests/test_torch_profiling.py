"""The port's profiling module (`dcnet_tpu_torch/utils/profiling.py`):
`summarize_trace` on a hand-written Chrome trace (exact rows), a CPU
`device_trace` read back by it, the launch-count check of
`chip_smoke.py --profile` for every hand-written kernel (K1-K6), and
`StepTimer.summary` against the JAX package's on the same times."""

import json
import os
import re

import numpy as np
import pytest
import torch

from dcnet_tpu.utils.profiling import StepTimer as JaxStepTimer
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
        with profiling.annotate("step"):
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


def test_step_timer_summary_equals_jax():
    times = [0.91, 0.0123, 0.0131, 0.0119, 0.0402, 0.0125]
    port, jax_timer = profiling.StepTimer(), JaxStepTimer()
    port.times, jax_timer.times = list(times), list(times)
    assert port.summary() == jax_timer.summary()
    one, jone = profiling.StepTimer(), JaxStepTimer()
    one.times, jone.times = [0.5], [0.5]
    assert one.summary() == jone.summary()
    for sync in (torch.ones(3), np.ones(3), None):
        with port.step() as box:
            if sync is not None:
                box["sync"] = sync
    assert len(port.times) == len(times) + 3 and all(t >= 0 for t in port.times)
