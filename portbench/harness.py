"""One run of one cell: set-up, the timed window, the traced sub-window,
the comparison that decides `correct`, and the metrics of the result.

Everything that belongs to one cell is found by name: the cell in
`BENCHMARK.json`, its configuration file, its traffic file
(`portbench/traffic/<traffic>.json`, whose `loop` names the loop in
`portbench/loops/`), its limits (`portbench/limits/<workload>.json`) and
each metric's reader (`portbench/metrics/<metric>.py`).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench import compare as C
from portbench import inputs
from portbench.reference.geometry import Geometry, geometry_from
from portbench.reference.model import param_spec
from portbench.weights import make_weights
from portbench.work.dcnet import unit_work

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "dcnet_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def banned_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (`dcnet_tpu_torch` is not `dcnet_tpu`)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(BANNED))


def model_weights(g: Geometry, seed: int, device) -> Dict[str, torch.Tensor]:
    """The benchmark's weights for a seed, drawn on the device
    (`portbench.weights`)."""
    return make_weights(param_spec(g), inputs.sub_seed(seed, "weights"), device)


@dataclasses.dataclass
class Context:
    workload: str
    seed: int
    device: torch.device
    geometry: Geometry
    traffic: dict

    def weights(self) -> Dict[str, torch.Tensor]:
        """The benchmark's weights for this seed, made anew on the device."""
        return model_weights(self.geometry, self.seed, self.device)


@dataclasses.dataclass
class Reading:
    """What the metric readers read."""

    traffic: dict
    setup_s: float
    units: int                 # timed units in the window
    items: int                 # items (predictions, clips) per unit
    window_s: float            # from the first unit's start to the last unit's end
    unit_s: List[float]        # each unit's time, hand-over to read-back
    host_s: List[float]        # each unit's host time in the program's call
    work: dict                 # portbench.work: operations and kernel bounds per unit
    trace: Optional[dict]      # the traced sub-window (--trace 1)


def reader(name: str) -> Callable[[Reading], Optional[float]]:
    """The `read` function of portbench/metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics._" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(man: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of this cell reports: with trace, the per-layer
    metrics listed for it (or, without a list, those whose `moves` metric
    the cell reports); without, its end-to-end metrics."""
    e2e = [m for m in man["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def loop(name: str):
    return importlib.import_module(f"portbench.loops.{name}")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None,
             root: str = ROOT, t_start: Optional[float] = None,
             geometry_overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None, controls=None) -> dict:
    """One run; returns the result's object (correct, attempted, failed,
    metrics, device, breakdown, checked). The overrides serve the tests'
    small sizes on the CPU; `controls` (precisions) adds the numbers of the
    reference at each precision put in the program's place, under
    `controls` (for setting limits, `portbench.readings`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest(root)
    cell = next(w for w in man["workloads"] if w["name"] == workload)
    conf = next(c for c in man["configs"] if c["name"] == cell["config"])
    traffic = load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    traffic.update(traffic_overrides or {})
    g = geometry_from(load_json(os.path.join(root, conf["file"])), **(geometry_overrides or {}))
    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ctx = Context(workload, seed, device, g, traffic)
    t_built = time.perf_counter()
    runner = loop(traffic["loop"]).Runner(ctx)
    t_runner = time.perf_counter()
    runner.warmup()
    first = runner.done

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    setup_s = time.perf_counter() - t_start
    phases = {"to_run_cell": t_built - t_start, "runner": t_runner - t_built,
              "warmup": t_start + setup_s - t_runner}
    print(f"set-up phases (s): {json.dumps({k: round(v, 3) for k, v in phases.items()})}",
          file=sys.stderr)
    unit_s, host_s = [], []
    t0 = time.perf_counter()
    while True:
        u0 = time.perf_counter()
        host_s.append(runner.run_unit())
        u1 = time.perf_counter()
        unit_s.append(u1 - u0)
        if u1 - t0 >= seconds:
            break
    window_s = u1 - t0
    last = first + len(unit_s)
    traced = None
    if trace:
        from portbench import trace as tracing
        traced = tracing.profile(runner.run_unit, traffic["trace_units"], device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    runner.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = runner.check(first, last)
    limits = C.limits_for(workload)
    correct = C.judge(numbers, limits)
    r = Reading(traffic, setup_s, len(unit_s), runner.items, window_s, unit_s, host_s,
                unit_work(g, traffic), traced)
    metrics = {}
    for m in cell_metrics(man, workload, trace):
        v = reader(m["name"])(r)
        if v is None:
            print(f"metric {m['name']}: nothing to read in this run", file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(unit_s) * runner.items, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if traced is not None:
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    if controls is not None:
        result["numbers"] = numbers
        result["unit_s"] = unit_s
        result["controls"] = {c: runner.check(first, last, control=c) for c in controls}
        result["setup_phases"] = phases
    result["checked"] = C.summary(numbers, limits)
    return result

