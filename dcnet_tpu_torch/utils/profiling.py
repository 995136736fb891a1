"""Profiling and tracing on torch.profiler: the port of
`dcnet_tpu/utils/profiling.py`, and the program's own spans and counters.

- `trace_annotation(name, device=None)`: the program's span, a context
  manager (or a decorator) that records the block into the ring `SPANS`
  on the host clock: name, parent span, root span, start and end
  (`time.perf_counter_ns`), whether a torch.profiler session was
  recording, for a root span the change of `COUNTERS` and of
  `kernels.LAUNCHES` over it, and with a CUDA `device` a CUDA event pair
  on the current stream. While a profiler records, the span also opens
  `torch.profiler.record_function(name)`, so the Chrome trace holds it as
  a `user_annotation` on the kernels' clock. Under `torch.export` (and
  `torch.compile`) a span does nothing. `record_spans(False)` stops the
  recording; `stage_ms`, `root_calls` and `stage_table` read the ring.
- `COUNTERS["host_syncs"]`: the host's waits on the card, counted where
  the program makes them (`count_sync`); `COUNTERS["graph_replays"]` and
  `COUNTERS["graph_captures"]`: the served ticks that replayed a CUDA graph,
  and the graphs captured (`serving/engine.py`, which adds a graph's
  captured kernel launches to `kernels.LAUNCHES` at each replay).
- `device_trace(log_dir)`: torch.profiler over a block, CPU plus CUDA on a
  card, writing a Chrome trace into `log_dir` (`cli/train.py --profile_dir`).
- `summarize_trace(logdir)`: the newest Chrome trace under `logdir` as a
  table, one row per device kernel or copy (total ms, % of the device
  total, count) and host events as totals, in `summarize_xplane`'s format;
  then, where the trace holds program spans, the table "by span": device
  ms, idle ms and launches under each span.
- The launch check of `chip_smoke.py --profile`: `KERNEL_GROUPS` names the
  hand-written kernels (K1-K7) by the functions a trace shows and the keys
  of `kernels.LAUNCHES` that count them; `profile_counts` holds the launches
  found by name against the wrappers' counts; `trace_call` traces one call
  of a function and `profile_call` discards a trace that lost kernels.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import glob
import gzip
import json
import os
import re
import threading
import time
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

from dcnet_tpu_torch import DeviceLike, kernels

# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

SPAN_RING = 65536
SPANS: Deque["trace_annotation"] = collections.deque(maxlen=SPAN_RING)
COUNTERS: Dict[str, int] = {"host_syncs": 0, "graph_replays": 0, "graph_captures": 0}
# a program span's name: <layer>.<stage>, lower case (PyTorch's own
# annotations, such as `Optimizer.step#RMSprop.step` or `ProfilerStep#2`,
# are not)
SPAN_NAME = re.compile(r"[a-z][a-z0-9_]*(?:\.[a-z][a-z0-9_]*)+")
_recording = True


class _Open(threading.local):
    """Each thread's open spans, innermost last."""

    def __init__(self) -> None:
        self.stack: List["trace_annotation"] = []


_OPEN = _Open()


def record_spans(on: bool = True) -> bool:
    """Switch the recording of spans on or off; returns the old setting."""
    global _recording
    old, _recording = _recording, bool(on)
    return old


def count_sync(device: torch.device, n: int = 1) -> None:
    """Count `n` waits of the host on the card (a copy to or from the host
    that is not asynchronous, a read of a value) where `device`, the
    device of the tensors involved, is a card."""
    if device.type == "cuda":
        COUNTERS["host_syncs"] += n


def on_device(x, device: torch.device) -> torch.Tensor:
    """`torch.as_tensor(x, device=device)`, counting the wait of a
    blocking copy from the host onto a card."""
    if not (torch.is_tensor(x) and x.device.type == device.type):
        count_sync(device)
    return torch.as_tensor(x, device=device)


def _counts() -> Dict[str, int]:
    return {**COUNTERS, **kernels.LAUNCHES}


class trace_annotation:
    """The program's span over a block (`with trace_annotation("engine.step"):`)
    or over every call of a function (`@trace_annotation("dcnet.trunk")`).

    On exit the span itself is appended to `SPANS` as its record: `name`,
    `parent` (the innermost span open around it in this thread, or None),
    `root` (the outermost; a root span is its own), `t0` / `t1` in
    `time.perf_counter_ns()` (read first on entry, by a decorated function
    before it makes its span, and last before the record is appended),
    `profiled` (a torch.profiler session was
    recording at its start), `counts` (root spans only: the change of every
    `COUNTERS` and `kernels.LAUNCHES` key over the call) and `events` (a
    CUDA event pair on the current stream where `device` is a card, none
    while the stream is captured; `device_ms()` reads it)."""

    __slots__ = ("name", "device", "parent", "root", "t0", "t1", "profiled", "counts",
                 "events", "_on", "_mirror")

    def __init__(self, name: str, device: Optional[torch.device] = None) -> None:
        self.name = name
        self.device = device
        self.parent = self.root = self.counts = self.events = self._mirror = None
        self.t0 = self.t1 = 0
        self.profiled = self._on = False

    def __enter__(self) -> "trace_annotation":
        # the readings bracket the span's own bookkeeping, so that a root
        # span covers all but a few us of its caller's reading of the call
        t0 = time.perf_counter_ns()
        if not _recording or torch.compiler.is_compiling():
            return self
        stack = _OPEN.stack
        parent = stack[-1] if stack else None
        self.parent = parent
        self.root = self if parent is None else parent.root
        self.profiled = _autograd_profiler._is_profiler_enabled
        if self.profiled:
            self._mirror = torch.profiler.record_function(self.name)
            self._mirror.__enter__()
        if parent is None:
            self.counts = _counts()
        dev = self.device
        if dev is not None and dev.type == "cuda" and \
                not torch.cuda.is_current_stream_capturing():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(dev))
        stack.append(self)
        self._on = True
        self.t0 = t0
        return self

    def __exit__(self, *exc) -> bool:
        if not self._on:
            return False
        self._on = False
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        stack = _OPEN.stack
        if stack and stack[-1] is self:
            stack.pop()
        if self.parent is None:
            now = _counts()
            self.counts = {k: v - self.counts.get(k, 0) for k, v in now.items()}
        if self._mirror is not None:
            self._mirror.__exit__(*exc)
            self._mirror = None
        self.t1 = time.perf_counter_ns()
        SPANS.append(self)
        return False

    def __call__(self, fn):
        name, device = self.name, self.device

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            t0 = time.perf_counter_ns()    # before the span object is made
            with trace_annotation(name, device) as span:
                span.t0 = t0
                return fn(*args, **kwargs)
        return spanned

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def device_ms(self) -> Optional[float]:
        """The card's time between the span's events (waits for the end
        event), or None without events."""
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])

    def __repr__(self) -> str:
        return f"trace_annotation({self.name!r}, {self.host_ms:.3f} ms)"


def root_calls(root: str, last: Optional[int] = None) -> List[trace_annotation]:
    """The root spans named `root` recorded with no profiler running, oldest
    first (the last `last` of them), each with every span under it still in
    the ring."""
    # once the ring is full, a call that started before its oldest record
    # ended may have lost spans to it
    since = SPANS[0].t1 if len(SPANS) == SPANS.maxlen else 0
    calls = [s for s in SPANS if s.parent is None and s.name == root and not s.profiled
             and s.t0 >= since]
    return calls if last is None else calls[-last:]


def _stage_total(calls: Sequence[trace_annotation], stage: str,
                 device: bool) -> Optional[float]:
    """The ms of every `stage` span under the calls: host ms, or the card's
    (None where one of them has no events)."""
    ids = {id(c) for c in calls}
    total = 0.0
    for s in SPANS:
        if s.name == stage and id(s.root) in ids:
            ms = s.device_ms() if device else s.host_ms
            if ms is None:
                return None
            total += ms
    return total


def stage_ms(root: str, stage: str, last: Optional[int] = None,
             device: bool = False) -> Optional[float]:
    """The mean ms that the `stage` spans of a root call take, over the
    last `last` root calls named `root` recorded with no profiler running
    (all of them with None): host ms, or with `device` the card's ms
    between their CUDA events. None where there are fewer calls than
    `last` or none, and with `device` where a span has no events."""
    calls = root_calls(root, last)
    if not calls or (last is not None and len(calls) < last):
        return None
    total = _stage_total(calls, stage, device)
    return None if total is None else total / len(calls)


def _depth(span: trace_annotation) -> int:
    depth = 0
    while span.parent is not None:
        depth, span = depth + 1, span.parent
    return depth


def stage_table(root: str, last: Optional[int] = None) -> str:
    """Every stage of the root calls named `root` (`stage_ms` of each, host
    and, where the spans have events, device ms) and the mean change of
    each counter and launch count that moved, a call."""
    calls = root_calls(root, last)
    if not calls:
        return f"(no {root} call recorded)"
    ids = {id(c) for c in calls}
    stages: Dict[str, Tuple[int, bool]] = {}   # name: (depth, has events), in order
    for s in sorted((s for s in SPANS if id(s.root) in ids),
                    key=lambda s: (s.t0, _depth(s))):
        stages[s.name] = (_depth(s), stages.get(s.name, (0, False))[1] or bool(s.events))
    out = [f"{root}: mean ms a call over {len(calls)} calls",
           f"{'host ms':>10} {'device ms':>10}  span"]
    for name, (depth, timed) in stages.items():
        host = _stage_total(calls, name, False) / len(calls)
        dev = _stage_total(calls, name, True) if timed else None
        dev = f"{'':>10}" if dev is None else f"{dev / len(calls):10.3f}"
        out.append(f"{host:10.3f} {dev}  {'  ' * depth}{name}")
    moved = {k: sum(c.counts[k] for c in calls) / len(calls) for k in calls[0].counts}
    out.append("counts a call: " + (", ".join(f"{k} {v:g}" for k, v in moved.items() if v)
                                    or "none"))
    return "\n".join(out)


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
    events = _read_trace(paths[-1])
    planes: Dict[str, Dict[str, Dict[str, Tuple[float, int]]]] = {}
    for ev in events:
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
    rows = span_rows(events)
    if rows:
        out.append("\nby span: device ops under the innermost program span around their "
                   "launching runtime call, idle gaps under the one around their middle")
        out.append(f"{'device ms':>12} {'idle ms':>10} {'launches':>9} {'calls':>6}  span")
        for name, dev_us, idle_us, launches, calls in rows:
            out.append(f"{dev_us / 1e3:12.3f} {idle_us / 1e3:10.3f} {launches:9d} "
                       f"{calls:6d}  {name}")
    return "\n".join(out)


OUTSIDE = "(outside every span)"


def span_rows(events: List[dict]) -> List[Tuple[str, float, float, int, int]]:
    """Chrome trace events (times in us) by program span: (span, device us,
    idle us, launches, calls), the most device time first. A device op
    (kernel, copy, memset) goes under the innermost program span (the
    shortest `user_annotation` whose name is a `SPAN_NAME`) around the
    runtime call of the same `correlation` id that launched it; an idle
    gap between the device's busy intervals under the innermost span
    around its middle; what no span holds under `OUTSIDE`. Empty where
    the trace holds no program span."""
    spans, launch_at, dev = [], {}, []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, ts, dur = str(ev.get("cat", "")), float(ev["ts"]), float(ev["dur"])
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and SPAN_NAME.fullmatch(str(ev.get("name", ""))):
            spans.append((ts, ts + dur, ev["name"]))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launch_at[corr] = ts
        elif cat in DEVICE_CATEGORIES:
            dev.append((ts, ts + dur, corr))
    if not spans:
        return []

    def innermost(t: Optional[float]) -> str:
        inside = [sp for sp in spans if t is not None and sp[0] <= t <= sp[1]]
        return min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside else OUTSIDE

    table: Dict[str, List] = {}

    def row(name: str) -> List:
        return table.setdefault(name, [name, 0.0, 0.0, 0, 0])

    for _, _, name in spans:
        row(name)[4] += 1
    for s, e, corr in dev:
        r = row(innermost(launch_at.get(corr)))
        r[1] += e - s
        r[3] += 1
    busy = _merge([(s, e) for s, e, _ in dev])
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        row(innermost((e0 + s1) / 2))[2] += s1 - e0
    return sorted((tuple(r) for r in table.values()), key=lambda r: (-r[1], -r[2], r[0]))


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


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
    ("bn_act", ("bn_act",), ("bn_act_kernel",)),
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
        # the schedule's step annotation and the program's spans span the call
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    e.self_device_time_total > 0 and not e.key.startswith("ProfilerStep") \
                    and not SPAN_NAME.fullmatch(e.key):
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
