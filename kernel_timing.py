"""Kernel timers of the PyTorch/CUDA port, and a comparison of two checkouts.

`chip_smoke.py` times its kernels with `device_ms` (one replay of a CUDA
graph of the calls: device time) and `cuda_ms` (calls enqueued from the
host: a call's time). Run as a script, this module times the bf16
co-attention kernels K1 (B=8), K2 (B=16) and K4 (B=120 at P=1024, 8
otherwise), C=512, with the fp32 K1 at P=1024 as a control, in two
checkouts of the repository with both timers, in turns (other, this,
this, other), each run in its own process importing its checkout's
`dcnet_tpu_torch`:

    python3 kernel_timing.py OTHER_CHECKOUT      # needs one CUDA card

Prints one JSON line per run and a summary line, each case's readings in
both checkouts.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

import torch

# What "ms", "plain_ms" and "library_ms" of a kernel record measure
TIMERS = {"device": "CUDA events around one replay of a CUDA graph of the "
                    "calls (device_ms): device time, no host gap",
          "call": "CUDA events around calls enqueued from the host "
                  "(cuda_ms): a call's time, its host cost included where "
                  "the device work is shorter"}


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events over `iters`
    calls enqueued from the host: a call's time, its host launch cost
    included where the device work is shorter."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


@functools.lru_cache(maxsize=None)
def _timing_stream() -> torch.cuda.Stream:
    return torch.cuda.Stream()


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn()'s device work, by CUDA events around one
    replay of a CUDA graph of `iters` calls (captured after `warmup` calls
    on a side stream): the launches run back to back, with no host gap
    between them. One side stream serves every call: cuBLAS keeps a
    workspace for each stream it has run on."""
    side = _timing_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / iters


T, C, S, CENTER, SLOT = 10.0, 512, 5, 2, 2
CASES = ([("K1", torch.bfloat16, 8, p) for p in (64, 256, 1024, 169)]
         + [("K1", torch.float32, 8, 1024)]
         + [("K2", torch.bfloat16, 16, p) for p in (64, 256, 1024, 169)]
         + [("K4", torch.bfloat16, 120 if p == 1024 else 8, p)
            for p in (64, 256, 1024, 169)])


def time_cases() -> dict:
    """Both timers on every case of CASES, with this process's
    `dcnet_tpu_torch` (the checkout first on sys.path)."""
    from dcnet_tpu_torch.kernels import coattn

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    out = []
    for name, dtype, b, p in CASES:
        def rows(*shape):
            x = torch.randn(*shape, generator=gen)
            return torch.nn.functional.normalize(x, dim=-1).to(dev, dtype)

        if name == "K1":
            q, kv = rows(b, p, C), rows(b, p, C)
            fn = functools.partial(coattn.coattention_one, q, kv, T)
            iters = 20 if p >= 1024 else 50
        elif name == "K2":
            clip = rows(b, 2, p, C)

            def fn(f1=clip[:, 0], f2=clip[:, 1]):
                with torch.no_grad():
                    coattn.coattention_fused(f1, f2, T)
            iters = 10 if p >= 1024 else 30
        else:
            ring = rows(b, S, p, C)
            fn = functools.partial(coattn.coattention_ring, ring, T, CENTER, SLOT)
            iters = 10 if p >= 1024 else 30
        out.append({"kernel": name, "dtype": str(dtype).replace("torch.", ""),
                    "B": b, "P": p, "C": C, "device_ms": device_ms(fn, iters),
                    "call_ms": cuda_ms(fn, iters)})
    return {"source": coattn.__file__, "cases": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--worker", action="store_true",
                    help="time the checkout `other` in this process")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_timing: torch.cuda.is_available() is False; this "
              "script times kernels on a CUDA card", file=sys.stderr)
        return 2
    if args.worker:
        sys.path.insert(0, os.path.abspath(args.other))
        print(json.dumps(time_cases()), flush=True)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for label, root in (("other", args.other), ("this", here), ("this", here),
                        ("other", args.other)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                              root], capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        run = {"checkout": label, **json.loads(res.stdout.strip().splitlines()[-1])}
        print(json.dumps(run), flush=True)
        runs.append(run)
    summary = []
    for i, case in enumerate(runs[0]["cases"]):
        row = {k: case[k] for k in ("kernel", "dtype", "B", "P", "C")}
        for label in ("other", "this"):
            mine = [r["cases"][i] for r in runs if r["checkout"] == label]
            row[label] = {t: [c[t] for c in mine] for t in ("device_ms", "call_ms")}
        summary.append(row)
    print(json.dumps({"summary": summary, "timers": TIMERS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
