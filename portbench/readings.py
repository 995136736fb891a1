"""Readings for the limits of `correct`: runs a cell on several seeds in
one process, each with a short window, and writes per seed the numbers
the comparison read for the program and, for each control precision,
for the reference put in the program's place:

    python3 -m portbench.readings --workload <name> --seeds 11,12,13 \\
        --seconds 5 --controls fp8 --out out/readings.jsonl

The benchmark's own runs never run the controls.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--controls", default="", help="comma-separated precisions")
    p.add_argument("--control-seeds", type=int, default=3,
                   help="how many of the seeds also read the controls")
    p.add_argument("--fault", default="", help="a fault of portbench.faults to plant")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch

    from portbench import faults, harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    controls = tuple(c for c in args.controls.split(",") if c)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with faults.FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
            r = harness.run_cell(args.workload, seed, args.seconds, False, device="cuda",
                                 controls=controls if i < args.control_seeds else ())
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "correct": r["correct"],
                "checked": {k: v["value"] for k, v in r["checked"].items()},
                "numbers": r.get("numbers", {}), "controls": r.get("controls", {}),
                "unit_ms": [round(1e3 * u, 2) for u in r.get("unit_s", [])],
                "setup_phases": r.get("setup_phases", {}), "metrics": r["metrics"],
                "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
