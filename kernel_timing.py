"""Kernel timers of the PyTorch/CUDA port, and a comparison of two checkouts.

`chip_smoke.py` times its kernels with `device_ms` (one replay of a CUDA
graph of the calls: device time) and `cuda_ms` (calls enqueued from the
host: a call's time). Run as a script, this module times the
co-attention kernels at C=512: K4 on int8 rings (B=120 at P=1024, 8 at
P=169), the fp32 K1 (B=8), K2 (B=16) and K4 (B=120 at P=1024, 8 at P=169),
the backward K3 in fp32 and bf16 (B=16), the bf16 K1 (B=8) and K4
(B=120) at P=1024, and the location Gram K5 (fp32 ce, E=8: B=8 and 64 at
P=1344, B=2 at P=3549; beside its plain version and the trunk's rank-8
route, device time, and each of its kernels' device time by
torch.profiler), in two checkouts of the repository with both timers,
in turns (other, this, this, other), each run in its own process importing
its checkout's `dcnet_tpu_torch`:

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


def kernel_ms(fn, iters: int = 10) -> dict:
    """Mean device milliseconds per call of each kernel fn() launches, by
    name, from torch.profiler over `iters` calls after one warm-up call
    (for a kernel of several launches, the share of each)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            .split("(")[0][:60]: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages() if e.self_device_time_total > 0}


T, C, S, CENTER, SLOT = 10.0, 512, 5, 2, 2
MAIN_P = (64, 256, 1024, 169)
CASES = ([("K4", torch.int8, 120 if p == 1024 else 8, p) for p in (1024, 169)]
         + [("K1", torch.float32, 8, p) for p in MAIN_P]
         + [("K2", torch.float32, 16, p) for p in MAIN_P]
         + [("K4", torch.float32, 120 if p == 1024 else 8, p) for p in (1024, 169)]
         + [("K3", dt, 16, p) for dt in (torch.float32, torch.bfloat16) for p in MAIN_P]
         + [("K1", torch.bfloat16, 8, 1024), ("K4", torch.bfloat16, 120, 1024)]
         + [("K5", torch.float32, b, p) for b, p in ((8, 1344), (64, 1344), (2, 3549))])


def time_cases(kernels=()) -> dict:
    """Both timers on every case of CASES (of the named `kernels`, if any),
    with this process's `dcnet_tpu_torch` (the checkout first on sys.path)."""
    from dcnet_tpu_torch.kernels import coattn, locgram
    from dcnet_tpu_torch.models.heads import DenseBNReLU

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    out = []
    for name, dtype, b, p in CASES:
        if kernels and name not in kernels:
            continue
        extra = {}

        def rows(*shape, dtype=dtype):
            x = torch.nn.functional.normalize(torch.randn(*shape, generator=gen), dim=-1)
            if dtype == torch.int8:  # as the serving engine quantises its rings
                return torch.clamp(torch.round(x * 127.0), -127, 127).to(dev, dtype)
            return x.to(dev, dtype)

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
        elif name == "K3":
            q, kv = rows(b, p, C), rows(b, p, C)
            g = torch.randn(b, p, C, generator=gen).to(dev, dtype)
            fn = functools.partial(coattn.attend_bwd, q, kv, T, g)
            iters = 5 if p >= 1024 else 20
        elif name == "K5":  # a location-branch DenseBNReLU, folded
            mod = DenseBNReLU(p, C, dtype=dtype, device=dev).eval()
            with torch.no_grad():
                mod[0].weight.copy_(torch.randn(C, p, generator=gen))
                mod[0].bias.copy_(0.1 * torch.randn(C, generator=gen))
            w, bias = locgram.fold_dense_bn(mod)
            ce, obj = rows(b, p, 8), rows(b, p, dtype=torch.float32)
            fn = functools.partial(locgram.fused_loc_gram, ce, obj, w, bias)
            iters = 5 if b * p > 20000 else 20

            def route(mod=mod, ce=ce, obj=obj):
                with torch.no_grad():
                    mod(None, gram_factors=(ce, obj))
            extra = {"plain_device_ms": device_ms(functools.partial(
                locgram.loc_gram_plain, ce, obj, w, bias), iters),
                     "route_device_ms": device_ms(route, iters),
                     "kernels_ms": kernel_ms(fn)}
        else:
            ring = rows(b, S, p, C)
            fn = functools.partial(coattn.coattention_ring, ring, T, CENTER, SLOT)
            iters = 3 if b * p > 100000 else 30
        out.append({"kernel": name, "dtype": str(dtype).replace("torch.", ""),
                    "B": b, "P": p, "C": C, "device_ms": device_ms(fn, iters),
                    "call_ms": cuda_ms(fn, iters), **extra})
    return {"source": coattn.__file__, "cases": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--worker", action="store_true",
                    help="time the checkout `other` in this process")
    ap.add_argument("--kernels", default="",
                    help="comma-separated kernels to time (K1-K5; default all)")
    args = ap.parse_args(argv)
    only = [k for k in args.kernels.split(",") if k]
    if not torch.cuda.is_available():
        print("kernel_timing: torch.cuda.is_available() is False; this "
              "script times kernels on a CUDA card", file=sys.stderr)
        return 2
    if args.worker:
        sys.path.insert(0, os.path.abspath(args.other))
        print(json.dumps(time_cases(only)), flush=True)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for label, root in (("other", args.other), ("this", here), ("this", here),
                        ("other", args.other)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                              "--kernels", ",".join(only), root],
                             capture_output=True, text=True, timeout=900)
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
            row[label] = {t: [c[t] for c in mine] for t in (
                "device_ms", "call_ms", "plain_device_ms", "route_device_ms",
                "kernels_ms") if t in case}
        summary.append(row)
    print(json.dumps({"summary": summary, "timers": TIMERS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
