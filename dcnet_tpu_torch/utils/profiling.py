"""Profiling and tracing on torch.profiler: the port of
`dcnet_tpu/utils/profiling.py`.

- `trace_annotation` / `annotate`: a named range in the trace
  (`torch.profiler.record_function`).
- `device_trace(log_dir)`: torch.profiler over a block, CPU plus CUDA on a
  card, writing a Chrome trace into `log_dir` (`cli/train.py --profile_dir`).
- `summarize_trace(logdir)`: the newest Chrome trace under `logdir` as a
  table, one row per device kernel or copy (total ms, % of the device
  total, count) and host events as totals, in `summarize_xplane`'s format.
- `StepTimer`: wall-clock steps that end in a sync.
- The launch check of `chip_smoke.py --profile`: `KERNEL_GROUPS` names the
  hand-written kernels (K1-K6) by the functions a trace shows and the keys
  of `kernels.LAUNCHES` that count them; `profile_counts` holds the launches
  found by name against the wrappers' counts; `trace_call` traces one call
  of a function and `profile_call` discards a trace that lost kernels.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dcnet_tpu_torch import DeviceLike


def trace_annotation(name: str):
    """A named range in the trace."""
    return torch.profiler.record_function(name)


annotate = trace_annotation


def _traces_cuda(device: DeviceLike) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device: DeviceLike = None,
                 file_name: str = "trace.json") -> Iterator[torch.profiler.profile]:
    """torch.profiler over the block: the CPU, and CUDA where `device` is a
    card (None: where there is one). The card is synchronised before the
    trace stops, and the Chrome trace written to `log_dir/file_name` (not
    where `log_dir` is empty). Yields the profiler."""
    cuda = _traces_cuda(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(None if device is None else torch.device(device))
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, file_name))


# ---------------------------------------------------------------------------
# Chrome trace summaries
# ---------------------------------------------------------------------------

# torch.profiler's categories of work on the card; every other complete
# event is the host's (operators, runtime calls, annotations)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _read_trace(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def summarize_trace(logdir: str, top: int = 15) -> str:
    """Device time per kernel and copy from the newest Chrome trace
    (`*.json`, `*.json.gz`) under `logdir`: a text table per device, one row
    per name with total ms, % of that device's total and occurrences, the
    `top` largest first; host events by category, totals only."""
    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.json*"), recursive=True),
                   key=os.path.getmtime)
    paths = [p for p in paths if p.endswith((".json", ".json.gz"))]
    if not paths:
        return f"(no Chrome trace under {logdir})"
    planes: Dict[str, Dict[str, Dict[str, Tuple[float, int]]]] = {}
    for ev in _read_trace(paths[-1]):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = str(ev.get("cat", ""))
        if cat in DEVICE_CATEGORIES:
            plane, line = f"device {ev.get('pid', 0)}", "kernels and copies"
        else:
            plane, line = "host", cat or "(uncategorised)"
        agg = planes.setdefault(plane, {}).setdefault(line, {})
        tot, cnt = agg.get(ev.get("name", ""), (0.0, 0))
        agg[ev.get("name", "")] = (tot + float(ev["dur"]), cnt + 1)
    out = [f"trace: {paths[-1]}"]
    for pname in sorted(planes, key=lambda p: (p == "host", p)):
        lines = planes[pname]
        out.append(f"\nplane '{pname}': {len(lines)} event lines")
        for lname, agg in lines.items():
            total_us = sum(t for t, _ in agg.values())
            if pname == "host":
                out.append(f"  line '{lname}': {total_us / 1e3:.3f} ms event time, "
                           f"{len(agg)} distinct events")
                continue
            out.append(f"  line '{lname}': {total_us / 1e3:.3f} ms event time, "
                       f"{len(agg)} distinct ops")
            out.append(f"{'ms':>12} {'%':>6} {'count':>7}  op")
            for name, (dur, cnt) in sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]:
                out.append(f"{dur / 1e3:12.3f} {dur / max(total_us, 1e-9) * 100:6.1f} "
                           f"{cnt:7d}  {name[:90]}")
    return "\n".join(out)


class StepTimer:
    """Wall-clock step timing that waits for the step's work:
    `with timer.step() as box: ...; box["sync"] = out` copies `out` to the
    host at the end of the step; without it the card is synchronised (where
    CUDA was initialised)."""

    def __init__(self) -> None:
        self.times: List[float] = []

    @contextlib.contextmanager
    def step(self) -> Iterator[dict]:
        box: dict = {}
        t0 = time.perf_counter()
        yield box
        if "sync" in box and torch.is_tensor(box["sync"]):
            box["sync"].cpu()
        elif "sync" in box:
            np.asarray(box["sync"])
        elif torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)

    def summary(self) -> dict:
        arr = np.asarray(self.times[1:] or self.times)  # the first step warms up
        return {"mean_s": float(arr.mean()), "p50_s": float(np.median(arr)),
                "p90_s": float(np.percentile(arr, 90)), "n": int(arr.size)}


# ---------------------------------------------------------------------------
# The hand-written kernels' launches in a profile, against kernels.LAUNCHES
# ---------------------------------------------------------------------------

# (group, the kernels.LAUNCHES keys whose counts it sums, the __global__
# functions it covers). One count of a key is one launch of its group's
# functions, with three exceptions the groups spell out: K1 and K2 share
# one kernel (K2's direction is on grid.z), so their counts are held as a
# sum; a K3 call is two launches, its dq and its dkv grid; a K5 call too,
# its factor and its expansion pass.
KERNEL_GROUPS: Tuple[Tuple[str, Tuple[str, ...], Tuple[str, ...]], ...] = (
    ("coattn_attend+coattn_pair", ("coattn_attend", "coattn_pair"),
     ("attend_kernel", "attend_tf32_kernel", "attend_wgmma_kernel", "attend_wide_kernel")),
    ("coattn_attend_bwd:dq", ("coattn_attend_bwd",), ("bwd_dq_kernel", "bwd_wide_dq_kernel")),
    ("coattn_attend_bwd:dkv", ("coattn_attend_bwd",), ("bwd_dkv_kernel", "bwd_wide_dkv_kernel")),
    ("coattn_ring", ("coattn_ring",),
     ("ring_kernel", "ring_wide_kernel", "ring_wgmma_kernel", "ring_s8_kernel")),
    ("loc_gram:factor", ("loc_gram",), ("factor_kernel",)),
    ("loc_gram:expand", ("loc_gram",), ("expand_kernel",)),
    ("conv_s8", ("conv_s8",), ("conv_tma_kernel",)),
    ("conv_s8_halo", ("conv_s8_halo",), ("conv_halo_kernel",)),
    ("conv_s8_gather", ("conv_s8_gather",), ("conv_s8_kernel",)),
    ("conv_s8_quant", ("conv_s8_quant",), ("quant_pass_kernel",)),
)
_GROUP_OF = {fn: group for group, _, fns in KERNEL_GROUPS for fn in fns}
# a function name as a whole identifier inside a demangled signature
_FUNCTION = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
    sorted(map(re.escape, _GROUP_OF), key=len, reverse=True)) + r")(?![A-Za-z0-9_])")


def kernel_group(name: str) -> Optional[str]:
    """The group of a kernel's name as a trace gives it (a demangled
    signature), or None for a kernel that is not one of ours."""
    m = _FUNCTION.search(name)
    return _GROUP_OF[m.group(1)] if m else None


def profile_counts(rows: Sequence[Tuple[float, str, int]], counted: Dict[str, int]) -> dict:
    """Our kernels' launches and device ms by name in a profile (`rows`:
    (device us, name, calls) of every kernel), beside what the wrappers
    counted over the same call (`counted`: the change of every
    `kernels.LAUNCHES` key); `agree` says whether every group matches."""
    found = {group: 0 for group, _, _ in KERNEL_GROUPS}
    ms = {group: 0.0 for group, _, _ in KERNEL_GROUPS}
    for us, name, calls in rows:
        group = kernel_group(name)
        if group is not None:
            found[group] += calls
            ms[group] += us / 1e3
    want = {group: sum(counted.get(k, 0) for k in keys) for group, keys, _ in KERNEL_GROUPS}
    return {"by_kernel_name": found, "ms_by_kernel_name": ms, "counted": want,
            "agree": found == want}


PROFILE_ATTEMPTS = 3    # traces of a call before a lossy profile fails


class LostTrace(AssertionError):
    """Every trace of a call lost kernels or device time."""


def trace_call(fn) -> tuple:
    """One torch.profiler trace of fn on the card (after one traced and
    dropped): the kept call's key averages and table, its host wall ms and
    the change of every `kernels.LAUNCHES` key over it."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from dcnet_tpu_torch import kernels
    torch.cuda.synchronize()
    traced = {}

    def ready(p) -> None:   # the kept call's events, before the cycle clears them
        traced["events"] = p.key_averages()
        traced["table"] = traced["events"].table(sort_by="self_cuda_time_total", row_limit=60)

    # one call traced and dropped first: without it a trace lost the first
    # kernels of the call (up to 4 of K6's, the first layer among them)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1), on_trace_ready=ready) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        # a marker kernel opens the kept window: with the dropped call alone
        # one tick's trace still lost its first kernel (the first layer)
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        prof.step()
    counted = {key: kernels.LAUNCHES[key] - before[key] for key in before}
    return traced["events"], traced["table"], wall_ms, counted


def profile_call(fn, out_dir: str, tag: str, attempts: int = PROFILE_ATTEMPTS) -> dict:
    """torch.profiler over one call of fn (`trace_call`): device time by
    kernel (top entries), summed kernel time, the host wall time of the call
    and their ratio (the device's busy share), and our kernels' launches by
    name held against the wrappers' counts (`profile_counts`). A trace with
    no device time or a count that differs is discarded and the call traced
    again (a trace loses a few of a call's first kernels now and then: 2 of
    49 profiles on an H100); after `attempts` such traces it raises
    `LostTrace`. The full table goes to `out_dir/profile_<tag>.txt`."""
    lost = []
    for _ in range(attempts):
        events, table, wall_ms, counted = trace_call(fn)
        rows = []  # kernels only: operator rows would count their kernels twice, and
        # the schedule's step annotation spans the call
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    e.self_device_time_total > 0 and not e.key.startswith("ProfilerStep"):
                rows.append((e.self_device_time_total, e.key, e.count))
        rows.sort(reverse=True)
        total_ms = sum(r[0] for r in rows) / 1e3
        launches = profile_counts(rows, counted)
        if total_ms and launches["agree"]:
            break
        lost.append({"kernels": len(rows), "device_ms": total_ms,
                     "by_kernel_name": launches["by_kernel_name"],
                     "counted": launches["counted"]})
    else:
        raise LostTrace(f"profile {tag}: every trace lost kernels or device time: {lost}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{tag}.txt"), "w") as f:
        f.write(table)
        f.write("\n\nevery kernel: device ms, calls, name\n")
        for us, key, n in rows:
            f.write(f"{us / 1e3:10.4f} {n:6d} {key}\n")
    return {"wall_ms": wall_ms, "device_ms": total_ms,
            "device_busy_share": total_ms / wall_ms if wall_ms else None,
            "launches": launches, "traces_discarded": lost,
            "top": [{"name": k[:80], "ms": us / 1e3, "calls": n} for us, k, n in rows[:12]]}
