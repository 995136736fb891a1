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
torch.profiler), and the int8 convolution K6 at six shapes (`K6_SHAPES`)
on 8 and 120 frames, bf16 in to bf16 out and int8 in to int32 out (each
of its kernels' device time by torch.profiler), in two checkouts of the repository with both timers,
in turns (other, this, this, other), each run in its own process importing
its checkout's `dcnet_tpu_torch`:

    python3 kernel_timing.py OTHER_CHECKOUT      # needs one CUDA card
    python3 kernel_timing.py . --k6-plans        # K6's tiles and splits

Prints one JSON line per run and a summary line, each case's readings in
both checkouts.

`--paths` times, in the same turns, the main paths whose kernels are
called through the host: `chip_smoke.py`'s int8 eval (clips/s of the
64-clip call and its variants, beside the float bf16 `eval_clip`), and
its float and quantized serving ticks at 120 streams (s/tick by mode),
each checkout through its own `chip_smoke.py`; in this checkout it also
times the host cost of a call of each `torch.ops.dcnet.*` operator
against its real implementation called directly (`dispatch_us`):

    python3 kernel_timing.py OTHER_CHECKOUT --paths
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
         + [("K5", torch.float32, b, p) for b, p in ((8, 1344), (64, 1344), (2, 3549))]
         # K6 (P: the input side; C: the shape below): bf16 in quantized, bf16
         # out (the path's); int8 in, int32 out
         + [("K6", dt, b, c) for c in range(6) for b in (8, 120)
            for dt in (torch.bfloat16, torch.int8)])
# K6's shapes: (k, stride, pad, Ci, Co, input side): the headline 3x3, the
# /32 3x3 and 1x1, the trunk's 3x3, the first layer, a stride-2 3x3
K6_SHAPES = ((3, 1, 1, 256, 512, 16), (3, 1, 1, 512, 1024, 8), (1, 1, 0, 1024, 512, 8),
             (3, 1, 1, 512, 512, 32), (3, 1, 1, 3, 32, 256), (3, 2, 1, 256, 512, 32))


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
        elif name == "K6":
            from dcnet_tpu_torch.kernels import conv_s8
            k, stride, pad, ci, co, side = K6_SHAPES[p]
            w = torch.randint(-127, 128, (co, k, k, ci), generator=gen,
                              dtype=torch.int8).to(dev)
            if dtype == torch.int8:
                x = torch.randint(-127, 128, (b, side, side, ci), generator=gen,
                                  dtype=torch.int8).to(dev)
                fn = functools.partial(conv_s8.conv_s8, x, w, stride, pad)
            else:
                x = torch.randn(b, side, side, ci, generator=gen).to(dev, dtype)
                scale = torch.rand(co, generator=gen).to(dev) * 1e-4
                fn = functools.partial(conv_s8.conv_s8, x, w, stride, pad, in_inv=30.0,
                                       scale=scale, bias=scale, act="leaky",
                                       out_dtype=torch.bfloat16)
            iters = 5 if b * side * side * k * k * ci * co > 2e10 else 20
            extra = {"shape": K6_SHAPES[p], "kernels_ms": kernel_ms(fn)}
        else:
            ring = rows(b, S, p, C)
            fn = functools.partial(coattn.coattention_ring, ring, T, CENTER, SLOT)
            iters = 3 if b * p > 100000 else 30
        out.append({"kernel": name, "dtype": str(dtype).replace("torch.", ""),
                    "B": b, "P": p, "C": C, "device_ms": device_ms(fn, iters),
                    "call_ms": cuda_ms(fn, iters), **extra})
    return {"source": coattn.__file__, "cases": out}


def dispatch_us(calls: int = 2000, rounds: int = 3) -> dict:
    """Host microseconds a call, of each registered operator of this
    checkout (`torch.ops.dcnet.*`, through the dispatcher) and of its real
    implementation called directly, on small CUDA inputs whose kernels
    take less of the card than their calls take of the host: the host
    time of `calls` enqueued calls, the least of `rounds` taken in turns.
    None where the checkout registers no operators."""
    from dcnet_tpu_torch.kernels import coattn as kc
    from dcnet_tpu_torch.kernels import conv_s8 as kq
    if not hasattr(kq, "conv_s8_op"):
        return None
    import time
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rows(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(torch.bfloat16)

    q, kv, ring, xf = rows(1, 128, 128), rows(1, 128, 128), rows(1, 5, 128, 128), \
        rows(1, 8, 8, 64)
    x = torch.randint(-127, 128, (1, 8, 8, 64), dtype=torch.int8, device=dev, generator=gen)
    w = torch.randint(-127, 128, (64, 1, 1, 64), dtype=torch.int8, device=dev, generator=gen)
    conv = (x, w, 1, 0, None, None, None, None, None, torch.int32, None, None, 1, 1, None,
            None)
    cases = {
        "dcnet::attend": (lambda: kc.attend_op(q, kv, T),
                          lambda: kc._launch_attend(q, kv, T, False)),
        "dcnet::ring": (lambda: kc.ring_op(ring, T, 2, 4),
                        lambda: kc.coattention_ring(ring, T, 2, 4)),
        "dcnet::conv_s8": (lambda: kq.conv_s8_op(*conv),
                           lambda: kq._conv_s8_dispatch(*conv)),
        "dcnet::conv_s8_quant": (lambda: kq.quant_pass_op(xf, 64, 0.5, None),
                                 lambda: kq._quant_pass_launch(xf, 64, 0.5, None)),
    }
    out = {}
    for name, fns in cases.items():
        best = [float("inf"), float("inf")]
        for _ in range(rounds):
            for i, fn in enumerate(fns):
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                best[i] = min(best[i], (time.perf_counter() - t0) / calls * 1e6)
                torch.cuda.synchronize()
        out[name] = {"op_us": best[0], "direct_us": best[1], "dispatch_us": best[0] - best[1]}
    return out


def time_paths() -> dict:
    """This process's checkout (first on sys.path): `chip_smoke.py`'s int8,
    serving and serving_int8 phases after its build phase, their timing
    records, and `dispatch_us`."""
    import contextlib
    import io
    import time
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    out, seconds, timing = io.StringIO(), {}, {}
    with contextlib.redirect_stdout(out):
        cs.finish_k6_build(cs.phase_build())
        for name in ("int8", "serving", "serving_int8"):
            t0 = time.perf_counter()
            timing[name] = getattr(cs, f"phase_{name}")(dev)["timing"]
            seconds[name] = time.perf_counter() - t0
    return {"timing": timing, "seconds": seconds, "dispatch": dispatch_us(),
            "nvidia_smi": cs.nvidia_smi()}


def _paths_summary(runs: list) -> dict:
    """Each timing reading (clips/s, s/tick) by checkout, in run order."""
    rows = {}
    for run in runs:
        for phase, modes in run["timing"].items():
            for mode, rec in modes.items():
                key = "clips_per_s" if "clips_per_s" in rec else "s_per_tick"
                row = rows.setdefault(f"{phase}/{mode}", {"metric": key})
                row.setdefault(run["checkout"], []).append(rec[key])
    return rows


def time_k6_plans() -> list:
    """K6's TMA route at K6_SHAPES on 8 and 120 frames, int8 in to int32
    out, under other tiles and splits than `conv_plan` picks (the plan's
    choice marked): device time of each variant, for tuning the plan."""
    import dataclasses

    from dcnet_tpu_torch.kernels import conv_s8

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for shape in K6_SHAPES:
        k, stride, pad, ci, co, side = shape
        w = torch.randint(-127, 128, (co, k, k, ci), generator=gen, dtype=torch.int8,
                          device=dev)
        for b in (8, 120):
            x = torch.randint(-127, 128, (b, side, side, ci), generator=gen,
                              dtype=torch.int8, device=dev)
            plan = conv_s8.plan_for(x, w, stride, pad)
            if plan.route != "tma" or plan.quant_x:
                continue
            iters = 5 if b * side * side * k * k * ci * co > 2e10 else 20
            seen = {}
            for bn in (64, 128, 256):
                for splits in (1, 2, 4, 8):
                    if splits > plan.kiters:
                        continue
                    stage = (conv_s8.TMA_ROWS + bn) * plan.cbox
                    stages = max(2, min(conv_s8.MAX_STAGES, (conv_s8.SMEM_LIMIT - 1024 - 128)
                                        // stage))
                    var = dataclasses.replace(plan, bn=bn, splits=splits, stages=stages,
                                              smem=conv_s8._smem(stages, bn, plan.cbox))
                    fn = functools.partial(conv_s8._conv_tma, var, x, w, (None,) * 4, None,
                                           1, 1, torch.int32, None, None, None, None)
                    seen[f"bn{bn}_s{splits}"] = device_ms(fn, iters)
            out.append({"shape": shape, "B": b, "chosen": f"bn{plan.bn}_s{plan.splits}",
                        "device_ms": seen})
            print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--worker", action="store_true",
                    help="time the checkout `other` in this process")
    ap.add_argument("--kernels", default="",
                    help="comma-separated kernels to time (K1-K6; default all)")
    ap.add_argument("--paths", action="store_true",
                    help="time the int8 eval and the serving ticks through each "
                         "checkout's chip_smoke.py, and this checkout's operator "
                         "dispatch, instead of the kernels")
    ap.add_argument("--k6-plans", action="store_true",
                    help="time K6's TMA route under other tiles and splits "
                         "(this checkout only; `other` is ignored)")
    args = ap.parse_args(argv)
    only = [k for k in args.kernels.split(",") if k]
    if not torch.cuda.is_available():
        print("kernel_timing: torch.cuda.is_available() is False; this "
              "script times kernels on a CUDA card", file=sys.stderr)
        return 2
    if args.k6_plans:
        time_k6_plans()
        return 0
    if args.worker:
        sys.path.insert(0, os.path.abspath(args.other))
        if args.paths:
            os.chdir(os.path.abspath(args.other))
            print(json.dumps(time_paths()), flush=True)
        else:
            print(json.dumps(time_cases(only)), flush=True)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for label, root in (("other", args.other), ("this", here), ("this", here),
                        ("other", args.other)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                              "--kernels", ",".join(only), root]
                             + (["--paths"] if args.paths else []),
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        run = {"checkout": label, **json.loads(res.stdout.strip().splitlines()[-1])}
        print(json.dumps(run), flush=True)
        runs.append(run)
    if args.paths:
        print(json.dumps({"summary": _paths_summary(runs)}), flush=True)
        return 0
    summary = []
    for i, case in enumerate(runs[0]["cases"]):
        row = {k: case[k] for k in ("kernel", "dtype", "B", "P", "C", "shape") if k in case}
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
