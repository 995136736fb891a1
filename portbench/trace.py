"""The traced sub-window: torch.profiler over a few units after the timed
window, read from its Chrome trace. Device time is the union of the
intervals in which a kernel, copy or memset ran; each hand-written
kernel's time is found by its function's name in the demangled signature
(the benchmark's own copy of the names); idle gaps between device work
are named by the host operation running at their middle.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# the hand-written kernels by the device functions that implement them
KERNELS: Dict[str, Tuple[str, ...]] = {
    "k1": ("attend_kernel", "attend_tf32_kernel", "attend_wgmma_kernel", "attend_wide_kernel"),
    "k3": ("bwd_dq_kernel", "bwd_wide_dq_kernel", "bwd_dkv_kernel", "bwd_wide_dkv_kernel"),
    "k4": ("ring_kernel", "ring_wide_kernel", "ring_wgmma_kernel", "ring_s8_kernel"),
    "k6": ("conv_tma_kernel", "conv_halo_kernel", "conv_s8_kernel", "quant_pass_kernel"),
}
_OF = {fn: k for k, fns in KERNELS.items() for fn in fns}
_NAME = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
    sorted(map(re.escape, _OF), key=len, reverse=True)) + r")(?![A-Za-z0-9_])")


def kernel_of(name: str) -> Optional[str]:
    """The hand-written kernel a device function's name belongs to."""
    m = _NAME.search(name)
    return _OF[m.group(1)] if m else None


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def read_events(events: List[dict], top: int = 10) -> dict:
    """From Chrome trace events (times in microseconds): busy seconds, each
    kernel's device seconds, the top device operations and the longest
    idle gaps by host activity."""
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = str(ev.get("cat", ""))
        s, e = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        if cat in DEVICE_CATEGORIES:
            dev.append((s, e, str(ev.get("name", ""))))
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime", "python_function"):
            host.append((s, e, str(ev.get("name", "")), cat))
    spans = merge([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in spans)
    by_kernel: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for s, e, name in dev:
        k = kernel_of(name)
        if k is not None:
            by_kernel[k] = by_kernel.get(k, 0.0) + (e - s) * 1e-6
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    longest = sorted(((s1 - e0, (e0 + s1) / 2) for (_, e0), (s1, _) in zip(spans, spans[1:])),
                     reverse=True)[:top]
    gaps = []
    for length, mid in longest:
        inside = [h for h in host if h[0] <= mid <= h[1]]
        # the innermost host operation: the shortest that spans the middle
        name = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "(no host event)"
        gaps.append([name[:120], length * 1e-6])
    ops = sorted(([n[:120], t] for n, t in by_name.items()), key=lambda x: -x[1])
    return {"busy_s": busy * 1e-6, "kernel_s": by_kernel, "device_ops": ops[:top],
            "idle_gaps": gaps}


def profile(run_unit, units: int, device) -> dict:
    """Profile `units` calls of run_unit; returns read_events' readings
    plus `window_s` (the profiled wall time) and `units`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            run_unit()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    out = read_events(events)
    out.update(window_s=window, units=units)
    return out
