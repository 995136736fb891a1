"""Drives the PyTorch/CUDA port (`dcnet_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --profile DIR   # and torch.profiler tables of
                                          # eval_clip, train_step and a
                                          # serving tick

Phases, each printing JSON lines, any failure exiting non-zero:
  1. device  -- the card (nvidia-smi name and power limit), torch/CUDA
     versions; TF32 is switched off for matmuls and cuDNN convolutions.
  2. build   -- compiles every kernel from `dcnet_tpu_torch/csrc/` with nvcc,
     one process per source, all started together; prints ptxas's register
     and spill lines (and the spill bytes per library), and the counts of
     HGMMA (wgmma) and UTMALDG (TMA load) instructions in the coattn and
     coattn_ring libraries and of tensor-core instructions with a TF32
     operand (HMMA or HGMMA ... TF32) in coattn, coattn_bwd and coattn_ring
     (cuobjdump -sass), failing if any is 0; and in the kernel functions of
     K4's int8 block alone, integer wgmma (IGMMA) for the logits, HGMMA for
     PV and UTMALDG, failing if one is 0 or any IMMA is there.
  3. kernel  -- each kernel against its plain PyTorch version on the card at
     the main paths' shapes (plus a ragged P and batch-strided inputs),
     timed beside the plain version, one PyTorch library call and the
     card's bound: K1 (co-attention; fp32 on the 3xTF32 block at C=512 and
     80, bf16 at C=512 and 256 on the wgmma block, at C=80 on the WMMA
     block), K2 (the pair), K3 (the backward, 3xTF32; fp32 against the
     plain version in float64, at limits that add the summands' size;
     zeros, T=1 and a K3 that skips a streamed tile are shown to fail them),
     K4 (the ring: fp32, bf16 and int8 rings at every slot, int8 on the
     wgmma s8 block; zeros, T=1 and a kernel that ignores the slot are shown
     to fail the limits) and K5 (the fused location Gram by the rank-E
     algorithm, fp32 ce against the plain version in float64 and bf16 ce
     against the plain version, at P=1344 and the ragged 3549, E 1, 8 and
     17, C 6, 512 and 1028, each call repeated for equal bytes, timed beside
     the rank-8 route; zeros, a dropped obj and a dropped bias are shown to
     fail the limits). K5 runs on no path. Then K1-K4 at widths no
     configuration runs and the JAX package takes (C = 24, 528, 1024; int8 rings also 1056; P = 169 and
     1024) in every dtype: the general block, the WMMA block for bf16 at
     528, K3's general pass.
  4. slice   -- the full-width 256 px model (YOLOv3 backbone from a seeded
     Darknet `.weights` file, the rest from a seeded torch.Generator)
     answers batches of 5-frame clips through eval_clip -> decode_best; the
     kernel launch counts of that run are checked (12 per eval_clip), the
     outputs are held against the same model run on the CPU, K1 is held
     against its plain version on the model's own mapped features in each
     compute dtype, K5 (with the folded loc_text_embedding) against the
     trunk's rank-8 route on the coord_emb and obj_map of one fp32
     eval_clip, and eval_clip is timed in float32 and bfloat16.
  5. train   -- the same full-width model trains with the RMSprop recipe on
     synthetic k=2 clips (a colored box moving over noise) through
     train_epoch (launches checked: per step K2 3, K3 6, K1 0; losses
     finite; parameters and BN running statistics move) and validate; one
     fp32 train step on 4 clips is held against the same step on the CPU
     (losses) and against a float64 step on the CPU (BN running
     statistics; each module's gradient, within twice the CPU fp32 step's
     distance, a limit shown to reject a K3 that drops T from dq); K2 and
     K3 are held on the model's own inputs and upstream gradients in each
     compute dtype (fp32 K3 against float64, with the plain fp32 version's
     share of the limits); train_step is timed in float32 and bfloat16.
  6. serving -- the same full-width model, cast for serving, in bf16 serves
     120 streams through GroundingEngine: with coattn_multiref (float rings,
     a query swap on a third of the streams mid-run; launches per tick K4 3,
     K1 0), the default K1 path (K1 12, K4 0) and int8 rings; outputs
     finite; at 4 streams in fp32 the engine on the card against the same
     engine on the CPU tick by tick in each mode, and against eval_clip
     after n_frame ticks; K4 against its plain version on the engine's own
     rings in each ring dtype, and K1 on the default path's rings at 120
     streams; s/tick, predictions/s and peak GiB per mode.
Then the `kernels` line, the nvidia-smi line, and as the last line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

try:
    import dcnet_tpu_torch  # noqa: F401
    # the kernel phase times every kernel with device_ms, beside cuda_ms
    from kernel_timing import TIMERS, cuda_ms, device_ms
except ImportError as e:  # run outside a checkout of the repository
    sys.exit(f"chip_smoke: cannot import dcnet_tpu_torch ({e}); run it from "
             f"the root of a checkout")

from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.kernels import build
from dcnet_tpu_torch.kernels import coattn as k_coattn
from dcnet_tpu_torch.kernels import locgram as k_locgram
from dcnet_tpu_torch.ops import correspondence

# H100 SXM data-sheet peaks (dense), the card's memory rate. Each product
# is counted at the card's fastest route that keeps the TPU body's
# accuracy: bf16 x bf16 on the tensor cores (exact products); fp32 x fp32 by
# 3xTF32, three TF32 passes at 495 TFLOP/s (six bf16 products give the same
# rate), not the 67 TFLOP/s of FMA outside the tensor cores; fp32 x bf16 as
# a three-piece bf16 split of the fp32 operand (FP32_X_BF16).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3,
              torch.int8: 1979e12}
FP32_X_BF16 = 989e12 / 3
PEAK_BYTES = 3.35e12
TEMPERATURE = 10.0
KERNEL_B, KERNEL_C = 8, 512
TRAIN_B = 16                      # clips per train step (the JAX bench's)
TIMING_CLIPS = 64                 # the JAX bench's offline batch
MAIN_P = (64, 256, 1024)          # the three scales at 256 px
RAGGED_P = 169                    # the /32 scale at 416 px
# K1 against its plain version. On l2-normalised rows (C=512) an output
# element is about 0.044/sqrt(P): 1.4e-3 at P=1024. The bf16 limit is one
# bf16 step of the output (2^-7 relative < rtol 1e-2) plus 2e-4, well under
# the outputs themselves; the kernel rounds softmax weights scaled by its
# running max, the plain version the final weights, which leaves about 3e-3
# relative error. A kernel that writes zeros or ignores T fails (relative
# error 1 and 0.4); the kernel phase checks that the limits say so.
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=2e-4)}
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # ||got-want||/||want||
# K3 in bf16 against its plain version. Both compute in fp32 from the same
# inputs and round once to bf16; they may differ by one bf16 step of the
# output (2^-7 relative) where the fp32 summation order tips the rounding,
# plus fp32 noise near zero. K2's backward adds two K3 outputs in the input
# dtype: each term and the sum may each be one step off, so its bf16 limit
# adds 2^-7 (|term 1| + |term 2|). Zeros and T=1 fail these limits
# (checked per case).
BWD_TOL = {torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
# K3 in fp32 against its plain version in float64 (`k3_exact`). An fp32 sum
# errs in proportion to the size of its summands, not of the sum: where
# large terms cancel, two correct fp32 results differ by more than
# rtol |want| (one of five full runs failed a limit of 1e-5 + 1e-4 |want|
# against the fp32 plain version). So the limit adds `terms` times the
# summands' size, computed in float64 from the same inputs (the fp32
# counterpart of the bf16 checks' 2^-7 |term|):
#     dq:  T (|dS| |kv|)          dkv:  T (|dS|ᵀ |q|) + |W|ᵀ |g|
# beside a relative-l2 limit. The plain fp32 version on the card's inputs
# sits at or under a tenth of every limit (its share is recorded and held,
# `K3_PLAIN_SHARE`); zeros, T=1 and a K3 that leaves one streamed tile of 16
# rows out of its sums fail them (checked per case).
K3_F64_TOL = dict(rtol=1e-4, atol=1e-5, terms=1e-4, rel=1e-4)
K3_PLAIN_SHARE = 0.1
K3_DROPPED_ROWS = 16
K3_TOL = {torch.float32: K3_F64_TOL, **BWD_TOL}  # for the records
_BUILD_SUBDIR = os.path.join(build.BUILD_DIR, "smoke")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def agreement(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype,
              tol=None, terms=()):
    """(ok, max |got - want|, ||got - want|| / ||want||) at dtype's limits
    (`tol`, K1's by default); `terms` are the bf16 summands of `want`."""
    g, w = got.float(), want.float()
    tol = (tol or TOL)[dtype]
    limit = tol["atol"] + tol["rtol"] * w.abs()
    if dtype == torch.bfloat16:
        for t in terms:
            limit = limit + 2 ** -7 * t.float().abs()
    rel = ((g - w).norm() / w.norm()).item()
    ok = bool(((g - w).abs() <= limit).all()) and rel <= REL_TOL[dtype]
    return ok, (g - w).abs().max().item(), rel


def rejects(want, wrong_t, dtype, tol=None, terms=()) -> bool:
    """The limits reject zeros and the result at T=1."""
    return not (agreement(torch.zeros_like(want), want, dtype, tol, terms)[0]
                or agreement(wrong_t, want, dtype, tol, terms)[0])


def _k3_float64(q, kv, t: float, g):
    """float64 copies of q, kv and g, with W = softmax(T q kvᵀ) and
    dS = W (dW - rowsum(dW W)), dW = g kvᵀ, of K3's sums."""
    q64, kv64, g64 = (x.double() for x in (q, kv, g))
    w = torch.softmax(torch.matmul(q64, kv64.transpose(1, 2)) * t, dim=-1)
    dw = torch.matmul(g64, kv64.transpose(1, 2))
    return q64, kv64, g64, w, w * (dw - torch.sum(dw * w, dim=-1, keepdim=True))


def k3_exact(q, kv, t: float, g):
    """fp32 K3's reference: ((dq, dkv) of `attend_bwd_plain` on float64
    copies of q, kv and g, (the sizes of their summands)), all float64:
    dq's T (|dS| |kv|) and dkv's T (|dS|ᵀ |q|) + |W|ᵀ |g|."""
    q64, kv64, g64, w, ds = _k3_float64(q, kv, t, g)
    want = k_coattn.attend_bwd_plain(q64, kv64, t, g64)
    terms = (t * torch.matmul(ds.abs(), kv64.abs()),
             t * torch.matmul(ds.abs().transpose(1, 2), q64.abs())
             + torch.matmul(w.transpose(1, 2), g64.abs()))
    return want, terms


def k3_dropped_tile(q, kv, t: float, g, rows: int = K3_DROPPED_ROWS):
    """A wrong K3 for the limits to reject, in float64: one streamed tile
    of `rows` rows (from the middle of P) left out of each of K3's sums,
    the kv rows out of dq = T dS kv and the q and g rows out of
    dkv = T dSᵀ q + Wᵀ g, as a kernel whose loop skipped a tile would."""
    q64, kv64, g64, w, ds = _k3_float64(q, kv, t, g)
    p = q.shape[1]
    keep = torch.ones(p, dtype=torch.float64, device=q.device)
    start = (p // 2) // rows * rows
    keep[start:start + rows] = 0.0
    dq = t * torch.matmul(ds * keep, kv64)
    dkv = (t * torch.matmul((ds * keep[:, None]).transpose(1, 2), q64)
           + torch.matmul((w * keep[:, None]).transpose(1, 2), g64))
    return dq, dkv


def k3_agreement(got, want, terms, tol=K3_F64_TOL):
    """(ok, max |got - want|, relative l2, share) of an fp32 K3 output
    against its float64 reference at `tol`: |got - want| <= atol +
    rtol |want| + terms * (summands' size) everywhere and relative l2 <=
    rel. `share` is the largest fraction of a limit used, over the
    elementwise limit and the relative-l2 one."""
    d = (got.double() - want).abs()
    limit = tol["atol"] + tol["rtol"] * want.abs() + tol["terms"] * terms
    rel = (d.norm() / want.norm()).item()
    share = max((d / limit).max().item(), rel / tol["rel"])
    return share <= 1.0, d.max().item(), rel, share


def k3_check(got, q, kv, t: float, g) -> dict:
    """fp32 K3's (dq, dkv) `got` against its float64 reference on the same
    inputs: the kernel's agreement, the plain fp32 version's share of the
    limits (at most K3_PLAIN_SHARE: limits fp32 arithmetic meets), and
    whether the limits reject zeros, T=1 and the dropped tile, each output
    on its own."""
    want, terms = k3_exact(q, kv, t, g)
    plain = k_coattn.attend_bwd_plain(q, kv, t, g)
    wrong = {"zeros": [torch.zeros_like(w) for w in want],
             "T1": k_coattn.attend_bwd_plain(*(x.double() for x in (q, kv)), 1.0,
                                             g.double()),
             "dropped_tile": k3_dropped_tile(q, kv, t, g)}
    res = [k3_agreement(a, w, m) for a, w, m in zip(got, want, terms)]
    plain_share = max(k3_agreement(a, w, m)[3] for a, w, m in zip(plain, want, terms))
    rej = {k: all(not k3_agreement(x, w, m)[0] for x, w, m in zip(v, want, terms))
           for k, v in wrong.items()}
    return {"ok": all(r[0] for r in res) and plain_share <= K3_PLAIN_SHARE
            and all(rej.values()),
            "max_abs_err": max(r[1] for r in res), "rel_err": max(r[2] for r in res),
            "share_of_limit": max(r[3] for r in res),
            "plain_fp32_share_of_limit": plain_share, "limits_reject": rej,
            "want": want, "terms": terms}


def bound(ops: float, nbytes: float, peak_flops: float):
    """Least time (ms) for `ops` operations and `nbytes` bytes, and which
    of the two bounds it."""
    t_ops, t_bytes = ops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def itemsize(dtype: torch.dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def attend_bound(b: int, p: int, c: int, dtype: torch.dtype, directions: int = 1):
    """K1 (one direction) or K2 (two): 4 B P^2 C operations at the dtype's
    rate (bf16: 989 TFLOP/s; fp32: 3xTF32's 165) and 3 B P C elements
    moved, per direction."""
    return bound(directions * 4.0 * b * p * p * c,
                 directions * 3.0 * b * p * c * itemsize(dtype), PEAK_FLOPS[dtype])


def attend_bwd_bound(b: int, p: int, c: int, dtype: torch.dtype):
    """K3: the TPU body's five products, 2 B P^2 C operations each (10 B P^2
    C, the JAX cost estimate), each at its route's rate: fp32 inputs all
    five at 3xTF32's 165 TFLOP/s; bf16 inputs S = q kvᵀ and dW = g kvᵀ
    (bf16 x bf16) at 989 and dS kv, dSᵀ q, Wᵀ g (an fp32 operand) at 989 / 3;
    and 5 B P C elements moved (q, kv, g read; dq, dkv written)."""
    one = 2.0 * b * p * p * c
    if dtype == torch.bfloat16:
        t_ops = 2 * one / PEAK_FLOPS[torch.bfloat16] + 3 * one / FP32_X_BF16
    else:
        t_ops = 5 * one / PEAK_FLOPS[torch.float32]
    t_bytes = 5.0 * b * p * c * itemsize(dtype) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_device(dev) -> dict:
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "tf32": "off for matmuls and cuDNN convolutions (all phases)"}
    emit(info)
    return info


SOURCES = ("coattn", "coattn_bwd", "coattn_ring", "locgram")
# TF32_MMA: tensor-core instructions with a TF32 operand (HMMA.1688.F32.TF32
# of mma.sync, or HGMMA ... TF32)
SASS_COUNTED = {"coattn": ("HGMMA", "UTMALDG", "TF32_MMA"),
                "coattn_ring": ("HGMMA", "UTMALDG", "TF32_MMA"),
                "coattn_bwd": ("TF32_MMA",)}


def _has_op(line: str, op: str) -> bool:
    if op == "TF32_MMA":
        return "TF32" in line and ("HMMA" in line or "HGMMA" in line)
    return f" {op}" in line or f"\t{op}" in line


def _sass(name: str) -> list:
    """The lines of `cuobjdump -sass` (the toolkit's, beside nvcc) on the
    built library of `csrc/<name>.cu`."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", build.build([name])[name]],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {name}: {out.stderr.strip()[:500]}")
    return out.stdout.splitlines()


def sass_counts(name: str, opcodes, function: str = "") -> dict:
    """How many instructions of each opcode the built library of
    `csrc/<name>.cu` holds, or (`function`) the kernel functions whose
    mangled names contain it; TF32_MMA counts tensor-core instructions with
    a TF32 operand."""
    counts, inside = dict.fromkeys(opcodes, 0), not function
    for line in _sass(name):
        if "Function :" in line:
            inside = not function or function in line
        elif inside:
            for op in opcodes:
                counts[op] += _has_op(line, op)
    return counts


def spill_bytes(log: str) -> int:
    """Spill stores and loads summed over ptxas's `-v` lines of a build."""
    return sum(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", log))


def phase_build() -> None:
    t0 = time.perf_counter()
    build.build(SOURCES)
    k_coattn._lib()
    k_coattn._bwd_lib()
    k_coattn._ring_lib()
    k_locgram._lib()
    seconds = time.perf_counter() - t0
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "error", "wgmma",
                                       "setmaxnreg", "Performance")):
                print(f"[nvcc {name}] {line.strip()}", flush=True)
    sass = {n: sass_counts(n, ops) for n, ops in SASS_COUNTED.items()}
    # K4's int8 block: integer wgmma (IGMMA) for the logits, bf16 wgmma
    # (HGMMA) for PV, TMA loads, and no mma.sync integer product (IMMA)
    s8 = sass_counts("coattn_ring", ("IGMMA", "HGMMA", "UTMALDG", "IMMA"),
                     function="ring_s8_kernel")
    emit({"phase": "build", "kernels": list(SOURCES),
          "seconds": round(seconds, 3),
          "nvcc_seconds": {k: round(v, 3) for k, v in build.BUILD_SECONDS.items()},
          "sass_instructions": sass, "sass_int8_block": s8,
          "spill_bytes": {k: spill_bytes(v) for k, v in build.BUILD_LOG.items()}})
    if not all(v > 0 for counts in sass.values() for v in counts.values()):
        raise AssertionError(f"the co-attention libraries lack wgmma, TMA or "
                             f"TF32 tensor-core instructions: {sass}")
    if not (s8["IGMMA"] and s8["HGMMA"] and s8["UTMALDG"]) or s8["IMMA"]:
        raise AssertionError(f"K4's int8 block is not on wgmma s8 + bf16 "
                             f"wgmma + TMA alone: {s8}")


def _sdpa_backends(q, kv):
    """Names of the scaled_dot_product_attention backends that accept
    these (1-head, head dim C) inputs."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    ok = []
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([be]), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                torch.nn.functional.scaled_dot_product_attention(
                    q, kv, kv, scale=TEMPERATURE)
            ok.append(be.name)
        except RuntimeError:
            pass
    torch.cuda.synchronize()
    return ok


def _rows(gen, *shape):
    """l2-normalized rows, like the mapped features on the main paths."""
    return torch.nn.functional.normalize(torch.randn(*shape, generator=gen), dim=-1)


def _record(name, dtype, b, p, c, err, rel, serr, tol, rej, ok, k_ms, p_ms,
            l_ms, library_call, backends, bound_ms, bound_by, timer, body=None,
            call_ms=None, extra=None) -> dict:
    rec = {"phase": "kernel", "name": name,
           "dtype": str(dtype).replace("torch.", ""),
           "B": b, "P": p, "C": c, "T": TEMPERATURE, "body": body,
           "max_abs_err": err, "rel_err": rel, "max_abs_err_strided": serr,
           "tol": {"rel": REL_TOL[dtype], **tol[dtype]}, **(extra or {}),
           "limits_reject_zeros_and_T1": rej, "ok": ok,
           "timer": timer, "ms": k_ms, "call_ms": call_ms, "plain_ms": p_ms,
           "library_ms": l_ms, "library_call": library_call,
           "library_backends": backends, "bound_ms": bound_ms, "bound_by": bound_by}
    emit(rec)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{dtype} P={p} max err {err} / {serr}, rel "
                             f"{rel}, limits reject {rej}")
    return rec


# K1 at other widths (the launcher's choice by shape), B=8: bf16 C=256 on
# the wgmma block, C=80 on the WMMA block; fp32 C=80 on the 3xTF32 block
WIDTH_CASES = ((torch.bfloat16, 256, (169, 1024)), (torch.bfloat16, 80, (169, 1024)),
               (torch.float32, 80, (169, 1024)))
# Widths no configuration runs, which the JAX package takes (any
# --emb_size): not a multiple of 16, just past 512, twice 512. K1-K4 at
# each, in every dtype, at the ragged and the headline P (K4 at B=8: the
# general block at 120 streams would take seconds a launch); int8 rings
# also at 1056, past 1040, where 127² C passes 2^24. bf16 at 528 takes the
# WMMA block, every other case here the general block (K3: its general
# pass).
ANY_WIDTHS = (24, 528, 1024)
ANY_WIDTHS_INT8 = ANY_WIDTHS + (1056,)
ANY_WIDTH_P = (RAGGED_P, 1024)


def _width_shapes(b: int, dtypes=(torch.float32, torch.bfloat16), widths=ANY_WIDTHS):
    return [(dtype, b, p, c) for dtype in dtypes for c in widths for p in ANY_WIDTH_P]


def _iters(body: str, p: int, big: int, small: int) -> int:
    """Launches a timer replays: few for the general block (tens of ms a
    launch at P=1024), `big` at P >= 1024 and `small` below."""
    if body == "wide":
        return 3
    return big if p >= 1024 else small


def kernel_cases_k1(dev, gen, shapes=None) -> list:
    """K1 against its plain version at the eval path's request (B=8), and
    at the widths of WIDTH_CASES; `shapes` ((dtype, B, P, C), ...) in their
    place."""
    if shapes is None:
        shapes = [(dtype, KERNEL_B, p, KERNEL_C) for dtype in (torch.float32, torch.bfloat16)
                  for p in MAIN_P + (RAGGED_P,)]
        shapes += [(dtype, KERNEL_B, p, c) for dtype, c, ps in WIDTH_CASES for p in ps]
    cases = []
    for dtype, b, p, c in shapes:
        q = _rows(gen, b, p, c).to(dev, dtype)
        kv = _rows(gen, b, p, c).to(dev, dtype)
        got = k_coattn.coattention_one(q, kv, TEMPERATURE)
        want = k_coattn.attend_plain(q, kv, TEMPERATURE)
        torch.cuda.synchronize()
        ok, err, rel = agreement(got, want, dtype)
        rej = rejects(want, k_coattn.attend_plain(q, kv, 1.0), dtype)
        # a frame sliced out of a (B, 5, P, C) clip: batch-strided input
        clip = _rows(gen, b, 5, p, c).to(dev, dtype)
        sgot = k_coattn.coattention_one(clip[:, 2], clip[:, 0], TEMPERATURE)
        swant = k_coattn.attend_plain(clip[:, 2], clip[:, 0], TEMPERATURE)
        torch.cuda.synchronize()
        sok, serr, _ = agreement(sgot, swant, dtype)
        iters = _iters(k_coattn.attend_body(dtype, c), p, 20, 50)
        k_ms = device_ms(lambda: k_coattn.coattention_one(q, kv, TEMPERATURE), iters)
        call_ms = cuda_ms(lambda: k_coattn.coattention_one(q, kv, TEMPERATURE), iters)
        p_ms = device_ms(lambda: k_coattn.attend_plain(q, kv, TEMPERATURE), iters)
        q4, kv4 = q[:, None], kv[:, None]
        backends = _sdpa_backends(q4, kv4)
        l_ms = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kv4, kv4, scale=TEMPERATURE), iters)
        cases.append(_record(
            "coattn_attend", dtype, b, p, c, err, rel, serr, TOL, rej,
            ok and sok and rej, k_ms, p_ms, l_ms,
            "F.scaled_dot_product_attention(q, kv, kv, scale=T), (B, 1, P, C)",
            backends, *attend_bound(b, p, c, dtype), timer="device",
            body=k_coattn.attend_body(dtype, c), call_ms=call_ms))
    return cases


def kernel_cases_k2(dev, gen, shapes=None) -> list:
    """K2 (forward, both directions in one launch) against two plain
    directions at the train step's batch (B=16), on frames sliced out of
    (B, 2, P, C) clips as the k=2 path hands them over; `shapes` ((dtype,
    B, P, C), ...) in their place."""
    if shapes is None:
        shapes = [(dtype, TRAIN_B, p, KERNEL_C) for dtype in (torch.float32, torch.bfloat16)
                  for p in MAIN_P + (RAGGED_P,)]
    cases = []
    for dtype, b, p, c in shapes:
        clip = _rows(gen, b, 2, p, c).to(dev, dtype)
        f1, f2 = clip[:, 0], clip[:, 1]
        with torch.no_grad():
            o1, o2 = k_coattn.coattention_fused(f1, f2, TEMPERATURE)
        w1 = k_coattn.attend_plain(f1, f2, TEMPERATURE)
        w2 = k_coattn.attend_plain(f2, f1, TEMPERATURE)
        torch.cuda.synchronize()
        ok1, err1, rel1 = agreement(o1, w1, dtype)
        ok2, err2, rel2 = agreement(o2, w2, dtype)
        rej = (rejects(w1, k_coattn.attend_plain(f1, f2, 1.0), dtype)
               and rejects(w2, k_coattn.attend_plain(f2, f1, 1.0), dtype))
        # contiguous copies give the same result as the strided frames
        with torch.no_grad():
            c1, c2 = k_coattn.coattention_fused(f1.contiguous(),
                                                f2.contiguous(), TEMPERATURE)
        torch.cuda.synchronize()
        serr = max((c1 - o1).abs().max().item(), (c2 - o2).abs().max().item())
        iters = _iters(k_coattn.attend_body(dtype, c), p, 10, 30)

        def run_kernel():
            with torch.no_grad():
                k_coattn.coattention_fused(f1, f2, TEMPERATURE)

        k_ms = device_ms(run_kernel, iters)
        call_ms = cuda_ms(run_kernel, iters)
        p_ms = device_ms(lambda: (k_coattn.attend_plain(f1, f2, TEMPERATURE),
                                  k_coattn.attend_plain(f2, f1, TEMPERATURE)), iters)
        qs = torch.stack([f1, f2], dim=1)   # both directions as 2 heads
        kvs = torch.stack([f2, f1], dim=1)
        backends = _sdpa_backends(qs, kvs)
        l_ms = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, kvs, kvs, scale=TEMPERATURE), iters)
        cases.append(_record(
            "coattn_pair", dtype, b, p, c, max(err1, err2), max(rel1, rel2),
            serr, TOL, rej, ok1 and ok2 and rej and serr == 0.0, k_ms, p_ms,
            l_ms, "F.scaled_dot_product_attention(q, kv, kv, scale=T) on "
            "(B, 2, P, C): q = (f1, f2), kv = (f2, f1) as two heads",
            backends, *attend_bound(b, p, c, dtype, directions=2),
            timer="device", body=k_coattn.attend_body(dtype, c), call_ms=call_ms))
    return cases


def _k3_held(q, kv, g, dtype):
    """K3 on (q, kv, g) at its limits: fp32 against float64 (`k3_check`),
    bf16 against the plain version (BWD_TOL). Returns ([(ok, max err, rel)
    per output], the limits reject the wrong answers, the fp32 record)."""
    got = k_coattn.attend_bwd(q, kv, TEMPERATURE, g)
    if dtype == torch.float32:
        rec = k3_check(got, q, kv, TEMPERATURE, g)
        del rec["want"], rec["terms"]
        return [(rec["ok"], rec["max_abs_err"], rec["rel_err"])], all(
            rec["limits_reject"].values()), rec
    want = k_coattn.attend_bwd_plain(q, kv, TEMPERATURE, g)
    wrong = k_coattn.attend_bwd_plain(q, kv, 1.0, g)
    torch.cuda.synchronize()
    return ([agreement(a, w, dtype, BWD_TOL) for a, w in zip(got, want)],
            all(rejects(w, x, dtype, BWD_TOL) for w, x in zip(want, wrong)), None)


def kernel_cases_k3(dev, gen, shapes=None) -> list:
    """K3 (dq, dkv) at the train step's batch (B=16), on l2-normalized q,
    kv and a unit-normal upstream gradient, and on batch-strided inputs
    (frames and gradients sliced out of clips): fp32 against float64 at
    K3_F64_TOL, bf16 against its plain version; `shapes` ((dtype, B, P,
    C), ...) in their place."""
    if shapes is None:
        shapes = [(dtype, TRAIN_B, p, KERNEL_C) for dtype in (torch.float32, torch.bfloat16)
                  for p in MAIN_P + (RAGGED_P,)]
    cases = []
    for dtype, b, p, c in shapes:
        q = _rows(gen, b, p, c).to(dev, dtype)
        kv = _rows(gen, b, p, c).to(dev, dtype)
        g = torch.randn(b, p, c, generator=gen).to(dev, dtype)
        checks, rej, f64 = _k3_held(q, kv, g, dtype)
        clip = _rows(gen, b, 2, p, c).to(dev, dtype)
        gclip = torch.randn(b, 2, p, c, generator=gen).to(dev, dtype)
        schecks, srej, _ = _k3_held(clip[:, 0], clip[:, 1], gclip[:, 1], dtype)
        rej = rej and srej
        ok = all(x[0] for x in checks + schecks) and rej
        iters = _iters(k_coattn.attend_bwd_body(c), p, 5, 20)
        k_ms = device_ms(lambda: k_coattn.attend_bwd(q, kv, TEMPERATURE, g), iters)
        call_ms = cuda_ms(lambda: k_coattn.attend_bwd(q, kv, TEMPERATURE, g), iters)
        p_ms = device_ms(lambda: k_coattn.attend_bwd_plain(q, kv, TEMPERATURE, g),
                         iters)
        ql = q[:, None].detach().requires_grad_()
        kvl = kv[:, None].detach().requires_grad_()
        backends = _sdpa_backends(ql.detach(), kvl.detach())

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                ql, kvl, kvl, scale=TEMPERATURE)

        # autograd replays the backward on the forward's stream, so the
        # graph captures both: the backward's time is their difference
        l_ms = (device_ms(lambda: torch.autograd.grad(sdpa(), (ql, kvl), g[:, None]),
                          iters)
                - device_ms(sdpa, iters))
        cases.append(_record(
            "coattn_attend_bwd", dtype, b, p, c,
            max(x[1] for x in checks), max(x[2] for x in checks),
            max(x[1] for x in schecks), K3_TOL, rej, ok, k_ms, p_ms, l_ms,
            "torch.autograd.grad through F.scaled_dot_product_attention("
            "q, kv, kv, scale=T), (B, 1, P, C): dq and dkv = dk + dv "
            "(device time of forward and backward less the forward's)",
            backends, *attend_bwd_bound(b, p, c, dtype), timer="device",
            body=k_coattn.attend_bwd_body(c), call_ms=call_ms, extra=f64 and {
                "vs": "float64", "share_of_limit": f64["share_of_limit"],
                "plain_fp32_share_of_limit": f64["plain_fp32_share_of_limit"],
                "limits_reject": f64["limits_reject"]}))
    return cases


RING_S, RING_CENTER = 5, 2          # n_frame 5, the center frame
SERVE_STREAMS = 120                 # the JAX bench's serving batch (24 clips x 5)
RING_SLOTS = (None, 0, 1, 2, 3, 4)


def ring_bound(b: int, s: int, p: int, c: int, dtype: torch.dtype):
    """K4: 4 B (S-1) P^2 C operations (float rings at their dtype's peak;
    int8 rings: the QK half at the int8 peak, the PV half at bf16's), and
    B S P C input elements read once plus B (S-1) P C output elements
    (bf16 for int8 rings) written once."""
    ops = 4.0 * b * (s - 1) * p * p * c
    out_dt = torch.bfloat16 if dtype == torch.int8 else dtype
    nbytes = b * p * c * (s * itemsize(dtype) + (s - 1) * itemsize(out_dt))
    if dtype == torch.int8:
        t_ops = ops / 2 / PEAK_FLOPS[torch.int8] + ops / 2 / PEAK_FLOPS[torch.bfloat16]
        t_bytes = nbytes / PEAK_BYTES
        return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                           else "bytes")
    return bound(ops, nbytes, PEAK_FLOPS[dtype])


def _ring_input(gen, dtype, *shape):
    """l2-normalised rows in `dtype`; int8 as the serving engine quantises
    them (clip(round(127 f)))."""
    x = _rows(gen, *shape)
    if dtype == torch.int8:
        return torch.clamp(torch.round(x * 127.0), -127, 127).to(torch.int8)
    return x.to(dtype)


def check_ring(ring, t, center_t, slot) -> dict:
    """K4 at one slot against its plain version on the same ring, at the
    output dtype's limits; whether those limits reject zeros, T=1 and a
    kernel that ignores the slot (physical order; no different ring for
    slot None or S-1). Counts the comparison launch."""
    got = k_coattn.coattention_ring(ring, t, center_t, newest_slot=slot)
    want = k_coattn.ring_attend_plain(ring, t, center_t, newest_slot=slot)
    torch.cuda.synchronize()
    out_dt = want.dtype
    ok, err, rel = agreement(got, want, out_dt)
    rej = rejects(want, k_coattn.ring_attend_plain(ring, 1.0, center_t, slot), out_dt)
    if slot not in (None, ring.shape[1] - 1):
        blind = k_coattn.ring_attend_plain(ring, t, center_t)
        rej = rej and not agreement(blind, want, out_dt)[0]
    return {"agrees": ok, "max_abs_err": err, "rel_err": rel,
            "limits_reject": rej}


def kernel_cases_k4(dev, gen, shapes=None) -> list:
    """K4 against its plain version on (B, 5, P, C=512) rings of
    l2-normalised rows, float32, bfloat16 and int8, at every slot (None,
    0-4; center at temporal index 2): B = 120 (the serving batch) at
    P = 1024, B = 8 at P = 64, 256 and the ragged 169; `shapes` ((dtype,
    B, P, C), ...) in their place. Timed at slot 2. Library:
    F.scaled_dot_product_attention of the center expanded to (B, 4, P, C)
    against the gathered references (float rings; the int8 path has no
    library call)."""
    if shapes is None:
        shapes = [(dtype, SERVE_STREAMS if p == max(MAIN_P) else KERNEL_B, p, KERNEL_C)
                  for dtype in (torch.float32, torch.bfloat16, torch.int8)
                  for p in MAIN_P + (RAGGED_P,)]
    cases = []
    for dtype, b, p, c in shapes:
        ring = _ring_input(gen, dtype, b, RING_S, p, c).to(dev)
        checks = [check_ring(ring, TEMPERATURE, RING_CENTER, slot)
                  for slot in RING_SLOTS]
        iters = 3 if b == SERVE_STREAMS and dtype == torch.float32 else _iters(
            k_coattn.attend_body(dtype, c), p, 10, 30)
        k_ms = device_ms(lambda: k_coattn.coattention_ring(
            ring, TEMPERATURE, RING_CENTER, 2), iters)
        call_ms = cuda_ms(lambda: k_coattn.coattention_ring(
            ring, TEMPERATURE, RING_CENTER, 2), iters)
        p_ms = device_ms(lambda: k_coattn.ring_attend_plain(
            ring, TEMPERATURE, RING_CENTER, 2), iters)
        l_ms, backends, library_call = None, [], (
            "none: no PyTorch call computes int8-logit attention")
        if dtype != torch.int8:
            cs, rs = k_coattn.ring_slots(RING_S, RING_CENTER, 2)
            q = ring[:, cs:cs + 1].expand(b, RING_S - 1, p, c).contiguous()
            kv = ring[:, rs]
            backends = _sdpa_backends(q, kv)
            l_ms = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kv, kv, scale=TEMPERATURE), iters)
            library_call = ("F.scaled_dot_product_attention(center expanded "
                            "to (B, 4, P, C), refs, refs, scale=T)")
            del q, kv
        ok = all(x["agrees"] and x["limits_reject"] for x in checks)
        rec = {"phase": "kernel", "name": "coattn_ring",
               "dtype": str(dtype).replace("torch.", ""), "B": b, "S": RING_S,
               "P": p, "C": c, "T": TEMPERATURE, "slots": [str(x) for x in RING_SLOTS],
               "max_abs_err": max(x["max_abs_err"] for x in checks),
               "rel_err": max(x["rel_err"] for x in checks),
               "tol": {**TOL[torch.bfloat16 if dtype == torch.int8 else dtype],
                       "rel": REL_TOL[torch.bfloat16 if dtype == torch.int8 else dtype]},
               "limits_reject_zeros_T1_and_slot_blind": all(
                   x["limits_reject"] for x in checks), "ok": ok,
               "timer": "device", "ms": k_ms, "call_ms": call_ms,
               "plain_ms": p_ms, "library_ms": l_ms, "library_call": library_call,
               "library_backends": backends,
               "body": k_coattn.attend_body(dtype, c)}
        rec["bound_ms"], rec["bound_by"] = ring_bound(b, RING_S, p, c, dtype)
        emit(rec)
        if not ok:
            raise AssertionError(f"coattn_ring disagrees with its plain version: "
                                 f"{dtype} P={p}: {checks}")
        cases.append(rec)
        del ring
    return cases


# K5: P = all_positions at 256 px (the model's) and at 416 px (ragged);
# (B, P, E, C), timed: the eval request, the JAX bench's offline batch, the
# ragged P; then E and C that no configuration runs and the JAX function
# takes: one coordinate, one past a chunk of 16, a width under one 16-byte
# vector and one past 1024 (C % 8 != 0 in bf16)
LOC_P, LOC_P_RAGGED, LOC_E = 1344, 3549, 8
LOC_CASES = ((8, LOC_P, LOC_E, 512), (64, LOC_P, LOC_E, 512),
             (2, LOC_P_RAGGED, LOC_E, 512), (8, LOC_P, 1, 512), (8, LOC_P, 17, 512),
             (8, LOC_P, LOC_E, 6), (8, LOC_P, LOC_E, 1028))
# K5 against its plain version (the TPU kernel's Gram algorithm): fp32
# against the plain version on float64 copies of the inputs, where the
# rank-E kernel's fp32 sums sit ~1e-6 (relative) from the exact outputs of
# order 0.1-1; bf16 against the plain version on the same inputs (fp32
# sums, one rounding): an element may be one bf16 step apart (2^-7
# relative) where the summation order tips the rounding. Zeros, a kernel
# that drops obj and one that drops the bias (about a third of the outputs'
# size here) fail these limits (checked per case).
K5_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
          torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
# K5 against the trunk's rank-8 route in fp32: one function, two summation
# orders (P-term Gram rows against an E-term factorisation): rtol 1e-4, and
# atol 1e-5 of the largest output, relative l2 1e-4
ROUTE_RTOL, ROUTE_ATOL_REL, ROUTE_REL = 1e-4, 1e-5, 1e-4


def loc_gram_bound(b: int, p: int, e: int, c: int, dtype: torch.dtype):
    """K5: the least work of the function, 4 B P E C operations (the
    rank-E factorisation ce (ceᵀ (obj ∘ W)); the kernel's Gram algorithm
    does P/(2E) times more) at the fp32 rate, 3xTF32's 165 TFLOP/s (the
    math is fp32 for either ce dtype); ce, obj, w and b read once and the
    output (ce's dtype) written once: bound by those bytes."""
    nbytes = (itemsize(dtype) * b * p * e + 4 * (b * p + p * c + c)
              + itemsize(dtype) * b * p * c)
    return bound(4.0 * b * p * e * c, nbytes, PEAK_FLOPS[torch.float32])


def route_agreement(got: torch.Tensor, want: torch.Tensor):
    """(ok, max |got - want|, relative l2) at the rank-8 route's limits."""
    g, w = got.float(), want.float()
    limit = ROUTE_ATOL_REL * w.abs().max() + ROUTE_RTOL * w.abs()
    rel = ((g - w).norm() / w.norm()).item()
    return (bool(((g - w).abs() <= limit).all()) and rel <= ROUTE_REL,
            (g - w).abs().max().item(), rel)


def _random_dense_bn_relu(gen, p: int, c: int, dtype, dev):
    """A location-branch DenseBNReLU (P -> C) with random weights and
    running statistics, in eval mode."""
    from dcnet_tpu_torch.models.heads import DenseBNReLU

    mod = DenseBNReLU(p, c, dtype=dtype, device=dev).eval()
    with torch.no_grad():
        mod[0].weight.copy_(torch.randn(c, p, generator=gen))
        mod[0].bias.copy_(0.1 * torch.randn(c, generator=gen))
        mod[1].running_mean.copy_(0.1 * torch.randn(c, generator=gen))
        mod[1].running_var.copy_(0.5 + torch.rand(c, generator=gen))
        mod[1].weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
        mod[1].bias.copy_(0.1 * torch.randn(c, generator=gen))
    return mod


def loc_gram_reference(ce, obj, w, b):
    """What K5 is held against: `loc_gram_plain` on float64 copies of the
    inputs for fp32 ce (float64 out), on the inputs as they are for bf16
    ce (fp32 sums, bf16 out)."""
    if ce.dtype == torch.float32:
        ce, obj, w, b = (x.double() for x in (ce, obj, w, b))
    return k_locgram.loc_gram_plain(ce, obj, w, b)


def loc_gram_held(got, ce, obj, w, b) -> tuple:
    """(ok, max |got - want|, relative l2, {wrong answer: rejected}) of K5's
    output against `loc_gram_reference` at K5_TOL; the wrong answers are
    zeros, the function without obj and without the bias."""
    want = loc_gram_reference(ce, obj, w, b)
    ok, err, rel = agreement(got, want, ce.dtype, K5_TOL)
    wrong = {"zeros": torch.zeros_like(want),
             "obj_dropped": loc_gram_reference(ce, torch.ones_like(obj), w, b),
             "bias_dropped": loc_gram_reference(ce, obj, w, torch.zeros_like(b))}
    rej = {k: not agreement(v, want, ce.dtype, K5_TOL)[0] for k, v in wrong.items()}
    return ok, err, rel, rej


def kernel_cases_k5(dev, gen) -> list:
    """K5 against its reference (`loc_gram_held`), ce in fp32 and bf16, at
    LOC_CASES: w and b are `fold_dense_bn` of a random DenseBNReLU, ce unit
    rows, obj an l2-normalised map; a second call must give the same bytes.
    Timed beside the plain version and the trunk's rank-8 route
    (`DenseBNReLU(None, gram_factors=...)`, eval mode, in ce's dtype: the
    same factorisation by PyTorch calls, so no single library call and no
    library time); in fp32 the route's output is held at its limits too.
    Returns the records and the launches of the checked calls, counted
    without CUDA graphs (a captured call would count once and run at every
    replay), so the timing calls do not count."""
    cases, launches = [], 0
    for dtype in (torch.float32, torch.bfloat16):
        for b, p, e, c in LOC_CASES:
            mod = _random_dense_bn_relu(gen, p, c, dtype, dev)
            w, bias = k_locgram.fold_dense_bn(mod)
            ce = _rows(gen, b, p, e).to(dev, dtype)
            obj = _rows(gen, b, p).to(dev)
            kernels.reset_launches()
            got = k_locgram.fused_loc_gram(ce, obj, w, bias)
            again = k_locgram.fused_loc_gram(ce, obj, w, bias)
            launches += kernels.LAUNCHES["loc_gram"]
            with torch.no_grad():
                route = mod(None, gram_factors=(ce, obj)).reshape(b, p, c)
            torch.cuda.synchronize()
            same_bytes = torch.equal(got.view(torch.int16), again.view(torch.int16))
            ok, err, rel, rej = loc_gram_held(got, ce, obj, w, bias)
            r_ok, r_err, r_rel = route_agreement(got, route)
            iters = 5 if b * p * c > 10_000_000 else 20
            k_ms = device_ms(lambda: k_locgram.fused_loc_gram(ce, obj, w, bias), iters)
            call_ms = cuda_ms(lambda: k_locgram.fused_loc_gram(ce, obj, w, bias), iters)
            p_ms = device_ms(lambda: k_locgram.loc_gram_plain(ce, obj, w, bias), iters)

            def run_route():
                with torch.no_grad():
                    mod(None, gram_factors=(ce, obj))

            r_ms = device_ms(run_route, iters)
            rec = {"phase": "kernel", "name": "loc_gram",
                   "dtype": str(dtype).replace("torch.", ""), "B": b, "P": p,
                   "C": c, "E": e, "max_abs_err": err, "rel_err": rel,
                   "vs": "float64" if dtype == torch.float32 else "plain",
                   "tol": {**K5_TOL[dtype], "rel": REL_TOL[dtype]},
                   "limits_reject": rej, "bitwise_repeat": same_bytes,
                   "rank8_route": {"max_abs_err": r_err, "rel_err": r_rel,
                                   "held": dtype == torch.float32,
                                   "tol": {"rtol": ROUTE_RTOL,
                                           "atol_of_max": ROUTE_ATOL_REL,
                                           "rel": ROUTE_REL}},
                   "timer": "device", "ms": k_ms, "call_ms": call_ms,
                   "plain_ms": p_ms, "library_ms": None,
                   "library_call": "none: no single PyTorch call computes it",
                   "rank8_route_ms": r_ms, "library_backends": []}
            rec["bound_ms"], rec["bound_by"] = loc_gram_bound(b, p, e, c, dtype)
            rec["ok"] = (ok and all(rej.values()) and same_bytes
                         and (r_ok or dtype != torch.float32))
            emit(rec)
            if not rec["ok"]:
                raise AssertionError(f"loc_gram disagrees with its reference "
                                     f"or the rank-8 route: {rec}")
            cases.append(rec)
            del mod, ce, obj, got, again, route
    return cases, launches


def phase_kernel(dev):
    """K1-K5 against their plain versions on the card; returns the case
    records and K5's launches (K5 runs on no path: its count is that of
    the kernel phase's checked calls, one a case)."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = (kernel_cases_k1(dev, gen) + kernel_cases_k2(dev, gen)
             + kernel_cases_k3(dev, gen) + kernel_cases_k4(dev, gen))
    # every width the JAX package takes (ANY_WIDTHS)
    cases += (kernel_cases_k1(dev, gen, _width_shapes(KERNEL_B))
              + kernel_cases_k2(dev, gen, _width_shapes(TRAIN_B))
              + kernel_cases_k3(dev, gen, _width_shapes(TRAIN_B))
              + kernel_cases_k4(dev, gen, _width_shapes(KERNEL_B))
              + kernel_cases_k4(dev, gen, _width_shapes(KERNEL_B, (torch.int8,),
                                                        ANY_WIDTHS_INT8)))
    k5_cases, k5_launches = kernel_cases_k5(dev, gen)
    kernels.reset_launches()  # the comparison launches above do not count
    return cases + k5_cases, k5_launches


def full_width_config():
    from dcnet_tpu_torch.config import DCNetConfig
    return DCNetConfig(image_size=256, emb_size=512, lstm_hidden=512,
                       word_embedding_size=512, corpus_size=1000, query_len=20,
                       n_frames_test=5, split_corr_conv=True,
                       compute_dtype="float32")


def seeded_model(cfg, dev):
    """The full-width model on `dev`: the YOLOv3 backbone from a seeded
    Darknet `.weights` file through the port's reader, the rest from
    `seeded_init_(seed=0)`. Returns (model, layer defs, set-up seconds)."""
    from dcnet_tpu_torch.models.darknet import random_darknet_weights_file
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.weights import seeded_init_, splice_darknet_weights

    defs = _defs()
    t0 = time.perf_counter()
    model = DCNet(cfg, backbone_defs=defs, device=dev)
    seeded_init_(model, seed=0)
    os.makedirs(_BUILD_SUBDIR, exist_ok=True)
    wpath = os.path.join(_BUILD_SUBDIR, "backbone_seed0.weights")
    random_darknet_weights_file(defs, wpath, seed=0)
    try:
        splice_darknet_weights(model, wpath)
    finally:
        os.remove(wpath)
    return model, defs, time.perf_counter() - t0


def phase_slice(dev, profile_dir=None) -> dict:
    """The eval path on the card, on the full-width YOLOv3 model."""
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.ops.decode import decode_best

    cfg = full_width_config()
    size = cfg.image_size
    n_frame = 5
    model, defs, setup_s = seeded_model(cfg, dev)

    rng = np.random.RandomState(0)

    def request(clips):
        images = rng.rand(clips * n_frame, size, size, 3).astype(np.float32)
        ids = rng.randint(1, cfg.corpus_size, (clips, cfg.query_len))
        ids[:, 12:] *= rng.rand(clips, cfg.query_len - 12) < 0.5  # padding
        return torch.from_numpy(images), torch.from_numpy(ids)

    # --- the main path: a few requests of 8 clips, launch counts checked --
    kernels.reset_launches()
    answers = []
    for _ in range(3):
        images, ids = request(8)
        before = kernels.LAUNCHES["coattn_attend"]
        out = model.eval_clip(images.to(dev), ids.to(dev), n_frame=n_frame)
        dec = decode_best(out.outbox, cfg)
        torch.cuda.synchronize()
        step = kernels.LAUNCHES["coattn_attend"] - before
        if step != 12:
            raise AssertionError(f"eval_clip launched K1 {step} times, "
                                 f"expected 12 (4 references x 3 scales)")
        for s, ob in enumerate(out.outbox):
            g = cfg.grids[s]
            if tuple(ob.shape) != (8, 3, 5, g, g) or not torch.isfinite(ob).all():
                raise AssertionError(f"outbox[{s}] bad: {tuple(ob.shape)}")
        answers.append(dec.boxes[:, 0].cpu())
    launches = dict(kernels.LAUNCHES)
    if launches["coattn_attend"] != 36:
        raise AssertionError(f"main path launches {launches}")

    # --- the same weights and clips on the CPU (plain path, fp32) ----------
    images, ids = request(2)
    cpu_model = DCNet(cfg, backbone_defs=defs, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t1 = time.perf_counter()
    ref = cpu_model.eval_clip(images, ids, n_frame=n_frame)
    cpu_s = time.perf_counter() - t1
    got = model.eval_clip(images.to(dev), ids.to(dev), n_frame=n_frame)
    ref_dec, got_dec = decode_best(ref.outbox, cfg), decode_best(got.outbox, cfg)
    parity_err = max((g.cpu() - r).abs().max().item()
                     for g, r in zip(got.outbox, ref.outbox))
    for g, r in zip(got.outbox, ref.outbox):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-3, atol=1e-3)
    same_idx = all(torch.equal(getattr(got_dec, f).cpu(), getattr(ref_dec, f))
                   for f in ("best_n", "gi", "gj", "scale"))
    if not same_idx:
        raise AssertionError("decoded boxes differ between the card and CPU")
    del cpu_model

    # --- K5 on the trunk's own location-branch inputs ----------------------
    images, ids = request(8)
    k5_on_model = check_k5_on_model(model, images.to(dev), ids.to(dev), n_frame)

    # --- eval_clip throughput at 64 clips, fp32 and bf16 -------------------
    timing, main_path_k1 = {}, {}
    state = model.state_dict()
    for dtype_name in ("float32", "bfloat16"):
        m = model if dtype_name == "float32" else DCNet(
            cfg.replace(compute_dtype=dtype_name), backbone_defs=defs,
            device=dev)
        if m is not model:
            m.load_state_dict(state)
        main_path_k1[dtype_name] = check_k1_on_mapped_features(
            m, request(8)[0], n_frame)
        images, ids = request(TIMING_CLIPS)
        images, ids = images.to(dev), ids.to(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(2):
            decode_best(m.eval_clip(images, ids, n_frame=n_frame).outbox, cfg)
        torch.cuda.synchronize()
        iters = 5
        t1 = time.perf_counter()
        for _ in range(iters):
            dec = decode_best(m.eval_clip(images, ids, n_frame=n_frame).outbox, cfg)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t1) / iters
        if not torch.isfinite(dec.boxes).all():
            raise AssertionError(f"{dtype_name} boxes not finite")
        timing[dtype_name] = {"clips": TIMING_CLIPS, "s_per_eval_clip": dt,
                              "clips_per_s": TIMING_CLIPS / dt,
                              "frames_per_s": TIMING_CLIPS * n_frame / dt,
                              "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        if profile_dir:
            try:  # a diagnostic: a profiler that cannot trace is reported
                timing[dtype_name]["profile"] = profile_call(
                    lambda: m.eval_clip(images, ids, n_frame=n_frame),
                    profile_dir, f"eval_clip_{dtype_name}")
            except Exception as e:  # noqa: BLE001
                timing[dtype_name]["profile"] = {"error": repr(e)[:300]}
        del m
    rec = {"phase": "slice", "model": "YOLOv3/Darknet-53 + BiLSTM, 256 px, "
           "emb 512, hidden 512, corpus 1000, 5-frame clips, split corr_conv",
           "weights": "backbone: random_darknet_weights_file(seed=0) through "
                      "the port's .weights reader; rest: seeded_init_(seed=0)",
           "setup_s": setup_s, "requests": 3, "clips_per_request": 8,
           "launches": launches, "launches_per_eval_clip": 12,
           "main_path_k1": main_path_k1, "k5_on_model": k5_on_model,
           "cpu_parity": {"clips": 2, "max_abs_outbox_err": parity_err,
                          "rtol": 1e-3, "atol": 1e-3, "same_decoded_index": same_idx,
                          "cpu_s": cpu_s},
           "timing": timing, "kind": torch.cuda.get_device_name(dev),
           "nvidia_smi": nvidia_smi()}
    emit(rec)
    return rec


def check_k1_on_frames(per_frame, t: float, newest_slot=None) -> dict:
    """K1 against its plain version on the frames a path hands it: per
    scale a (B, n_frame, h, w, C) stack (a request's mapped features, or a
    serving ring whose newest frame sits in slot `newest_slot`), the center
    frame against each reference, each a batch-strided frame view. K1's
    limits in the frames' dtype; raises on a mismatch. Resets the launch
    counts: comparison launches do not count."""
    dt = per_frame[0].dtype
    worst_abs, worst_rel, ok, pairs = 0.0, 0.0, True, 0
    for f in per_frame:
        b, n, c = f.shape[0], f.shape[1], f.shape[-1]
        frames = f.reshape(b, n, -1, c)
        cs, rs = k_coattn.ring_slots(n, n // 2, newest_slot)
        for r in rs:
            got = k_coattn.coattention_one(frames[:, cs], frames[:, r], t)
            want = k_coattn.attend_plain(frames[:, cs], frames[:, r], t)
            good, err, rel = agreement(got, want, dt)
            ok, worst_abs, worst_rel = (ok and good, max(worst_abs, err),
                                        max(worst_rel, rel))
            pairs += 1
    torch.cuda.synchronize()
    kernels.reset_launches()
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version on the "
                             f"path's frames ({dt}, slot {newest_slot}): max "
                             f"err {worst_abs}, rel {worst_rel}")
    return {"pairs": pairs, "max_abs_err": worst_abs, "rel_err": worst_rel,
            "tol": {**TOL[dt], "rel": REL_TOL[dt]}}


def check_k5_on_model(model, images, ids, n_frame) -> dict:
    """K5 on what the trunk hands its location branch in one fp32
    eval_clip: the coord_emb (B, P, 8) and obj_map (B, P) that
    `loc_text_embedding(None, gram_factors=...)` receives, with
    `fold_dense_bn(loc_text_embedding)`, against that route's own output
    (the rank-8 factorisation, eval mode) at the route limits, and against
    K5's plain version on float64 copies at its limits. Resets the launch
    counts."""
    lte = model.loc_text_embedding
    seen = {}
    forward = lte.forward

    def capture(x, gram_factors=None, train=False):
        out = forward(x, gram_factors=gram_factors, train=train)
        seen["ce"], seen["obj"] = (t.detach() for t in gram_factors)
        seen["out"] = out.detach()
        return out

    lte.forward = capture
    try:
        with torch.no_grad():
            model.eval_clip(images, ids, n_frame=n_frame)
    finally:
        del lte.forward
    ce, obj = seen["ce"].contiguous(), seen["obj"].contiguous()
    w, b = k_locgram.fold_dense_bn(lte)
    got = k_locgram.fused_loc_gram(ce, obj, w, b)
    route = seen["out"].reshape(got.shape)
    torch.cuda.synchronize()
    kernels.reset_launches()
    r_ok, r_err, r_rel = route_agreement(got, route)
    ok, err, rel, _ = loc_gram_held(got, ce, obj, w, b)
    rec = {"shape": {"B": ce.shape[0], "P": ce.shape[1], "E": ce.shape[2],
                     "C": w.shape[1], "dtype": str(ce.dtype).replace("torch.", "")},
           "vs_rank8_route": {"max_abs_err": r_err, "rel_err": r_rel,
                              "max_abs_route": route.abs().max().item(),
                              "tol": {"rtol": ROUTE_RTOL,
                                      "atol_of_max": ROUTE_ATOL_REL,
                                      "rel": ROUTE_REL}},
           "vs_plain_float64": {"max_abs_err": err, "rel_err": rel,
                                "tol": {**K5_TOL[ce.dtype], "rel": REL_TOL[ce.dtype]}},
           "relu_zero_share": (route == 0).float().mean().item()}
    if not (r_ok and ok):
        raise AssertionError(f"K5 disagrees on the model's own inputs: {rec}")
    return rec


def check_k1_on_mapped_features(model, images, n_frame) -> dict:
    """K1 against its plain version on the inputs eval_clip hands it: the
    model's own mapped features of one request, in its compute dtype."""
    feats = model.extract_features(images.to(model.device))
    b = feats[0].shape[0] // n_frame
    return check_k1_on_frames([f.reshape(b, n_frame, *f.shape[1:]) for f in feats],
                              model.cfg.coattn_temperature)


# --- the train path -------------------------------------------------------

TRAIN_STEPS = 3                   # train_epoch steps of the main path
PARITY_CLIPS = 4                  # clips of the card-vs-CPU train step
TIMED_STEPS, WARMUP_STEPS = 5, 2
COLORS = {"red": (200, 40, 40), "green": (40, 180, 60), "blue": (40, 70, 200),
          "yellow": (220, 200, 40), "purple": (150, 60, 180)}
SIDES = {"small": 30, "large": 70}
WORDS = {w: i + 1 for i, w in enumerate(
    ["the", "box", "moving", "left", "right", *SIDES, *COLORS])}


def synthetic_clips(rng, clips: int, k: int, size: int, query_len: int) -> dict:
    """k-frame clips of a colored box moving over noise, drawn as
    `dcnet_tpu/data/synthetic.py` draws its frames, at the model's input
    size and without cv2: images (clips, k, size, size, 3) in [0, 1],
    word_ids (clips, k, L) of "the <size> <color> box moving <dir>", bbox
    (clips, k, 4) xyxy pixels."""
    images = np.empty((clips, k, size, size, 3), np.float32)
    bbox = np.empty((clips, k, 4), np.float32)
    ids = np.zeros((clips, k, query_len), np.int64)
    for c in range(clips):
        color = list(COLORS)[rng.randint(len(COLORS))]
        side_name = "small" if rng.rand() < 0.5 else "large"
        direction = "left" if rng.rand() < 0.5 else "right"
        side = SIDES[side_name]
        cx, cy = rng.uniform(side, size - side, 2)
        vx = (-1 if direction == "left" else 1) * rng.uniform(5, 15)
        words = ["the", side_name, color, "box", "moving", direction]
        for f in range(k):
            img = rng.randint(0, 80, (size, size, 3)).astype(np.uint8)
            x1 = int(np.clip(cx - side / 2, 0, size - 2))
            y1 = int(np.clip(cy - side / 2, 0, size - 2))
            x2 = int(np.clip(cx + side / 2, x1 + 1, size - 1))
            y2 = int(np.clip(cy + side / 2, y1 + 1, size - 1))
            img[y1:y2, x1:x2] = COLORS[color]
            images[c, f] = img / 255.0
            bbox[c, f] = (x1, y1, x2, y2)
            ids[c, f, :len(words)] = [WORDS[w] for w in words]
            cx += vx
    return {"images": images, "word_ids": ids, "bbox": bbox}


def _deterministic_negatives(generator, pos_idx, num_items, neg_n):
    """The injected sampler of the parity step: the neg_n items after the
    positive, cyclically (no randomness, never the positive)."""
    steps = torch.arange(1, neg_n + 1, device=pos_idx.device)
    return (pos_idx.long()[..., None] + steps) % num_items


def _rel(got, want) -> float:
    g, w = got.float(), want.float()
    wn = w.norm().item()
    return 0.0 if wn == 0.0 and g.norm().item() == 0.0 else (g - w).norm().item() / wn


# Wrong K3 variants the gradient limit is shown against: the real kernel's
# outputs altered in the way a faulty K3 would alter them.
K3_FAULTS = {
    "dq_without_T": lambda t, dq, dkv: (dq / t, dkv),
    "outputs_rounded_to_bf16": lambda t, dq, dkv: (
        dq.bfloat16().to(dq.dtype), dkv.bfloat16().to(dkv.dtype)),
}


def _parity_step(pcfg, state0, batch, where, dtype_name, k3_fault=None):
    """One train step from state0: (metrics, gradients per top-level
    module, running statistics, seconds). `k3_fault` swaps K3 for
    K3_FAULTS[k3_fault] around the real kernel."""
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.train.loop import to_device
    from dcnet_tpu_torch.train.state import create_train_state
    from dcnet_tpu_torch.train.step import train_step

    m = DCNet(pcfg.replace(compute_dtype=dtype_name), backbone_defs=_defs(),
              device=where)
    m.load_state_dict(state0)
    if dtype_name == "float64":
        m.double()
    st = create_train_state(m, pcfg)
    bwd = k_coattn.attend_bwd
    if k3_fault:
        fault = K3_FAULTS[k3_fault]
        k_coattn.attend_bwd = lambda q, kv, t, g: fault(t, *bwd(q, kv, t, g))
    try:
        t0 = time.perf_counter()
        metrics = train_step(st, to_device(batch, where))
        if where.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        k_coattn.attend_bwd = bwd
    grads = {}
    for name, prm in m.named_parameters():
        grads.setdefault(name.split(".")[0], []).append(
            prm.grad.cpu().double().flatten())
    stats = {n: v.cpu().double() for n, v in m.state_dict().items()
             if "running_" in n}
    return ({k: float(v) for k, v in metrics.items()},
            {k: torch.cat(v) for k, v in grads.items()}, stats, seconds)


def _stats_err(got: dict, want: dict) -> tuple:
    """(worst |got - want| / (1e-5 + 1e-4 |want|) over every running
    statistic, its name): at most 1 is within rtol 1e-4 / atol 1e-5."""
    worst = (0.0, "")
    for n, w in want.items():
        r = ((got[n] - w).abs() / (1e-5 + 1e-4 * w.abs())).max().item()
        worst = max(worst, (r, n))
    return worst


def train_parity(cfg, state0, batch, dev) -> dict:
    """One fp32 train step on the card and on the CPU from the same weights
    and clips (dropout 0, the deterministic negatives on both; TF32 off),
    and the same step on the CPU in float64 as the exact reference.
    Each loss part: card within rtol 1e-3 of the CPU. Every BatchNorm's
    running statistics after the step: card within rtol 1e-4 / atol 1e-5
    of float64. Each top-level module's gradient: the card's relative l2
    distance from float64 at most max(1e-3, 2x the CPU fp32's own
    distance). The float64 step shows why the limit follows the CPU: at
    full width with random weights, the backward through 75 train-mode
    BatchNorms turns fp32 rounding into ~1e-2 of the backbone's gradient on
    any fp32 path (the card's and the CPU's alike: two independent draws of
    that error), while the card and the CPU in float64 agree to ~1e-8. The
    batch has 4 clips: the two frames of a clip share their phrase, so 2
    clips would give the phrase BatchNorm1d two distinct rows, whose
    backward is nearly all cancellation. Each of K3_FAULTS then runs on the
    card in K3's place; the limit must reject `dq_without_T`, and the
    reading of each is reported."""
    pcfg = cfg.replace(jemb_dropout=0.0, input_dropout=0.0)
    cpu = torch.device("cpu")
    sampler = correspondence._sample_negatives_excluding
    correspondence._sample_negatives_excluding = _deterministic_negatives
    try:
        mc, gc, sc, card_s = _parity_step(pcfg, state0, batch, dev, "float32")
        mr, gr, sr, cpu_s = _parity_step(pcfg, state0, batch, cpu, "float32")
        _, g64, s64, cpu64_s = _parity_step(pcfg, state0, batch, cpu, "float64")
        faulty = {f: _parity_step(pcfg, state0, batch, dev, "float32", f)[1]
                  for f in K3_FAULTS}
    finally:
        correspondence._sample_negatives_excluding = sampler
    loss_rel = {k: abs(mc[k] - mr[k]) / max(abs(mr[k]), 1e-12)
                for k in mr if k.startswith("loss")}
    card_vs_64 = {k: _rel(gc[k], g64[k]) for k in g64}
    cpu_vs_64 = {k: _rel(gr[k], g64[k]) for k in g64}
    limit = {k: max(1e-3, 2 * v) for k, v in cpu_vs_64.items()}

    def over(grads):  # modules whose gradient is outside its limit
        return {k: _rel(grads[k], g64[k]) for k in limit
                if _rel(grads[k], g64[k]) > limit[k]}

    faults = {f: {"rejected": bool(over(g)), "over_limit": over(g),
                  "grad_rel_l2_vs_cpu_fp64": {k: _rel(g[k], g64[k]) for k in g64}}
              for f, g in faulty.items()}
    stats_card, stats_cpu = _stats_err(sc, s64), _stats_err(sr, s64)
    ok = (all(v <= 1e-3 for v in loss_rel.values()) and not over(gc)
          and stats_card[0] <= 1.0 and faults["dq_without_T"]["rejected"])
    rec = {"clips": batch["images"].shape[0] // 2, "loss_rel_err": loss_rel,
           "rtol_loss": 1e-3,
           "grad_rel_l2_card_fp32_vs_cpu_fp64": card_vs_64,
           "grad_rel_l2_cpu_fp32_vs_cpu_fp64": cpu_vs_64,
           "grad_rel_l2_card_vs_cpu_fp32": {k: _rel(gc[k], gr[k]) for k in gr},
           "grad_limit": limit,
           "running_stats": {"n": len(s64), "tol": "rtol 1e-4, atol 1e-5",
                             "card_vs_cpu_fp64_worst_over_tol": stats_card,
                             "cpu_fp32_vs_cpu_fp64_worst_over_tol": stats_cpu},
           "k3_faults": faults,
           "card_loss": {k: mc[k] for k in loss_rel},
           "cpu_loss": {k: mr[k] for k in loss_rel},
           "card_s": card_s, "cpu_s": cpu_s, "cpu_fp64_s": cpu64_s, "ok": ok}
    if not ok:
        emit({"phase": "train_parity", **rec})
        raise AssertionError("the card's train step disagrees with the CPU's")
    return rec


@functools.lru_cache(maxsize=None)
def _defs():
    """The YOLOv3 layer list every full-width model here is built from."""
    from dcnet_tpu_torch.models.darknet import yolov3_layer_defs
    return yolov3_layer_defs()


def _unit_rms(g: torch.Tensor) -> torch.Tensor:
    return (g.float() / g.float().pow(2).mean().sqrt().clamp_min(1e-30)).to(g.dtype)


def check_k2_k3_on_model(state, batch) -> dict:
    """One train step with the pair wrapped: K2 is held against its plain
    version on the features the model hands it, and K3 (and K2's backward)
    on those features and the upstream gradients the real loss sends back
    (captured with tensor hooks, rescaled to unit RMS: K3 is linear in g),
    at each scale, in the model's compute dtype: fp32 K3 and K2's backward
    against float64 (`k3_check`, K3_F64_TOL, with the plain fp32 version's
    share of the limits and the wrong answers they reject), bf16 against
    the plain version (BWD_TOL)."""
    import dcnet_tpu_torch.models.dcnet as dcnet_mod
    from dcnet_tpu_torch.train.step import train_step

    dtype = state.model.dtype
    captured = []
    pair = dcnet_mod.coattention_pair_fused

    def wrapped(f1, f2, t):
        a1, a2 = pair(f1, f2, t)
        rec = {"f1": f1.detach(), "f2": f2.detach(), "t": t}
        a1.register_hook(lambda g: rec.__setitem__("g1", g.detach()))
        a2.register_hook(lambda g: rec.__setitem__("g2", g.detach()))
        captured.append(rec)
        return a1, a2

    dcnet_mod.coattention_pair_fused = wrapped
    try:
        train_step(state, batch)
    finally:
        dcnet_mod.coattention_pair_fused = pair
    worst = {"k2": [0.0, 0.0], "k3": [0.0, 0.0], "k2_bwd": [0.0, 0.0]}
    f64 = {"share_of_limit": 0.0, "plain_fp32_share_of_limit": 0.0,
           "limits_reject": {}}
    ok = len(captured) == 3

    def note(key, res):
        nonlocal ok
        ok = ok and res[0]
        worst[key] = [max(worst[key][0], res[1]), max(worst[key][1], res[2])]

    for rec in captured:
        b, h, w, c = rec["f1"].shape
        f1, f2 = (rec[k].reshape(b, h * w, c) for k in ("f1", "f2"))
        g1, g2 = (_unit_rms(rec[k].reshape(b, h * w, c)) for k in ("g1", "g2"))
        t = rec["t"]
        with torch.no_grad():
            o1, o2 = k_coattn.coattention_fused(f1, f2, t)
        note("k2", agreement(o1, k_coattn.attend_plain(f1, f2, t), dtype))
        note("k2", agreement(o2, k_coattn.attend_plain(f2, f1, t), dtype))
        got1 = k_coattn.attend_bwd(f1, f2, t, k_coattn._rows_contiguous(g1))
        got2 = k_coattn.attend_bwd(f2, f1, t, k_coattn._rows_contiguous(g2))
        if dtype == torch.float32:
            held = [k3_check(got1, f1, f2, t, g1), k3_check(got2, f2, f1, t, g2)]
            for r in held:
                note("k3", (r["ok"], r["max_abs_err"], r["rel_err"]))
                f64["share_of_limit"] = max(f64["share_of_limit"], r["share_of_limit"])
                f64["plain_fp32_share_of_limit"] = max(
                    f64["plain_fp32_share_of_limit"], r["plain_fp32_share_of_limit"])
                for k, v in r["limits_reject"].items():
                    f64["limits_reject"][k] = f64["limits_reject"].get(k, True) and v
            (want1, terms1), (want2, terms2) = ((r["want"], r["terms"]) for r in held)
            for i, j in ((0, 1), (1, 0)):  # df1 = dq1 + dkv2, df2 = dkv1 + dq2
                note("k2_bwd", k3_agreement(got1[i] + got2[j], want1[i] + want2[j],
                                            terms1[i] + terms2[j])[:3])
            del held, want1, want2, terms1, terms2
            continue
        want1 = k_coattn.attend_bwd_plain(f1, f2, t, g1)
        want2 = k_coattn.attend_bwd_plain(f2, f1, t, g2)
        for a, x in zip(got1 + got2, want1 + want2):
            note("k3", agreement(a, x, dtype, BWD_TOL))
        note("k2_bwd", agreement(got1[0] + got2[1], want1[0] + want2[1], dtype,
                                 BWD_TOL, terms=(want1[0], want2[1])))
        note("k2_bwd", agreement(got1[1] + got2[0], want1[1] + want2[0], dtype,
                                 BWD_TOL, terms=(want1[1], want2[0])))
    torch.cuda.synchronize()
    kernels.reset_launches()  # comparison launches do not count
    res = {"scales": len(captured),
           **{f"{k}_max_abs_err": v[0] for k, v in worst.items()},
           **{f"{k}_rel_err": v[1] for k, v in worst.items()},
           "g": "captured upstream gradient, rescaled to unit RMS"}
    if dtype == torch.float32:
        res["k3_vs_float64"] = {**f64, "tol": K3_F64_TOL,
                                "plain_share_at_most": K3_PLAIN_SHARE}
    if not ok:
        raise AssertionError(f"K2/K3 disagree with their references on the "
                             f"model's inputs ({dtype}): {res}")
    return res


def phase_train(dev, profile_dir=None) -> dict:
    """The train path on the card: the full-width model, the RMSprop recipe,
    16-clip k=2 batches of synthetic clips."""
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.train.loop import (
        flatten_clip_batch, to_device, train_epoch, validate)
    from dcnet_tpu_torch.train.state import create_train_state
    from dcnet_tpu_torch.train.step import train_step

    cfg = full_width_config()
    size, k = cfg.image_size, cfg.n_frames_train
    model, _, setup_s = seeded_model(cfg, dev)
    state0 = {n: v.detach().cpu().clone() for n, v in model.state_dict().items()}
    rng = np.random.RandomState(1)
    batches = [synthetic_clips(rng, TRAIN_B, k, size, cfg.query_len)
               for _ in range(TRAIN_STEPS)]
    state = create_train_state(model, cfg, steps_per_epoch=TRAIN_STEPS)

    # --- the main path: train_epoch, launches counted -----------------------
    kernels.reset_launches()
    t0 = time.perf_counter()
    averages = train_epoch(state, batches, epoch=0, print_freq=1,
                           generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = {"coattn_attend": 0, "coattn_pair": 3 * TRAIN_STEPS,
            "coattn_attend_bwd": 6 * TRAIN_STEPS, "coattn_ring": 0, "loc_gram": 0}
    if launches != want:
        raise AssertionError(f"train_epoch launches {launches}, expected {want}")
    if not all(np.isfinite(v) for v in averages.values()):
        raise AssertionError(f"train metrics not finite: {averages}")
    after = model.state_dict()
    moved = {}
    for name, v in after.items():
        if name.endswith("num_batches_tracked"):
            continue
        kind = ("running_stats" if "running_" in name else name.split(".")[0])
        d = (v.detach().cpu() - state0[name]).abs().max().item()
        moved[kind] = max(moved.get(kind, 0.0), d)
    if min(moved.values()) <= 0.0:
        raise AssertionError(f"some parameters or BN statistics did not move: {moved}")

    # --- validate: eval_step over two batches --------------------------------
    val = validate(model, [synthetic_clips(rng, TRAIN_B, k, size, cfg.query_len)
                           for _ in range(2)])
    if not all(0.0 <= v <= 1.0 for v in val.values()):
        raise AssertionError(f"validate metrics out of range: {val}")

    # --- one fp32 step on the card against the same step on the CPU ----------
    parity = train_parity(cfg, state0, flatten_clip_batch(
        synthetic_clips(rng, PARITY_CLIPS, k, size, cfg.query_len)), dev)

    # --- train_step at 16 clips, fp32 and bf16; K2/K3 on the model's inputs --
    timing, on_model = {}, {}
    del model, state
    for dtype_name in ("float32", "bfloat16"):
        m = DCNet(cfg.replace(compute_dtype=dtype_name), backbone_defs=_defs(),
                  device=dev)
        m.load_state_dict(state0)
        st = create_train_state(m, cfg)
        batch = to_device(flatten_clip_batch(
            synthetic_clips(rng, TRAIN_B, k, size, cfg.query_len)), dev)
        on_model[dtype_name] = check_k2_k3_on_model(st, batch)
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(WARMUP_STEPS):
            train_step(st, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            metrics = train_step(st, batch)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t1) / TIMED_STEPS
        if not all(torch.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{dtype_name} train metrics not finite")
        timing[dtype_name] = {
            "clips": TRAIN_B, "frames": TRAIN_B * k, "s_per_step": dt,
            "frames_per_s": TRAIN_B * k / dt,
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "loss": float(metrics["loss"])}
        if profile_dir:
            try:  # a diagnostic: a profiler that cannot trace is reported
                timing[dtype_name]["profile"] = profile_call(
                    lambda: train_step(st, batch), profile_dir,
                    f"train_step_{dtype_name}")
            except Exception as e:  # noqa: BLE001
                timing[dtype_name]["profile"] = {"error": repr(e)[:300]}
        del m, st
    kernels.reset_launches()
    rec = {"phase": "train", "model": "YOLOv3/Darknet-53 + BiLSTM, 256 px, "
           "emb 512, hidden 512, corpus 1000, k=2 clips, RMSprop lr 1e-4 "
           "(backbone x0.1), wd 5e-4",
           "data": "synthetic_clips: a colored box moving over noise, seed 1",
           "setup_s": setup_s, "steps": TRAIN_STEPS, "clips_per_step": TRAIN_B,
           "epoch_s": epoch_s, "launches": launches,
           "launches_per_step": {k_: v // TRAIN_STEPS for k_, v in launches.items()},
           "train_averages": averages, "moved_max_abs": moved,
           "validate": val, "cpu_parity": parity, "k2_k3_on_model": on_model,
           "timing": timing, "kind": torch.cuda.get_device_name(dev),
           "nvidia_smi": nvidia_smi()}
    emit(rec)
    return rec


# --- the serving path -----------------------------------------------------

SERVE_TICKS = 12                  # the fusion window (5) is full from tick 4
SWAP_TICK = 6                     # update_queries on a third of the streams
PARITY_STREAMS, PARITY_TICKS = 4, 6
WARMUP_TICKS, TIMED_CHAINS, CHAIN_TICKS = 3, 3, 10
# card vs CPU at 4 streams, fp32, TF32 off: raw and fused boxes (pixels) and
# scores elementwise within rtol 1e-3 / atol 1e-3
SERVE_TOL = dict(rtol=1e-3, atol=1e-3)
# streamed against eval_clip on the card, float rings: the CPU test's limits
OFFLINE_BOX_TOL = dict(rtol=1e-4, atol=1e-4)
OFFLINE_SCORE_TOL = dict(rtol=1e-4, atol=1e-5)


def serving_config(**over):
    """The JAX bench's serving configuration of the full-width model:
    split_corr_conv off (the serving default)."""
    return full_width_config().replace(split_corr_conv=False, **over)


def _phrases(rng, cfg, n: int) -> torch.Tensor:
    ids = rng.randint(1, cfg.corpus_size, (n, cfg.query_len))
    ids[:, 12:] *= rng.rand(n, cfg.query_len - 12) < 0.5  # padding
    return torch.from_numpy(ids)


def _serve(eng, ids, ticks: int, frames_at, swap=None):
    """Ticks 0..ticks-1 of a fresh engine state, with an optional
    (tick, word_ids, mask) query swap: (state, launches of each tick,
    outputs of each tick)."""
    state = eng.init_state(ids)
    per_tick, outs = [], []
    for t in range(ticks):
        if swap is not None and t == swap[0]:
            state = eng.update_queries(state, swap[1], mask=swap[2])
        before = dict(kernels.LAUNCHES)
        state, fused, raw, score = eng.step(state, frames_at(t))
        per_tick.append({k: kernels.LAUNCHES[k] - before[k] for k in before})
        outs.append((fused, raw, score))
    torch.cuda.synchronize()
    return state, per_tick, outs


def _expect_launches(per_tick, want: dict, what: str) -> None:
    for t, got in enumerate(per_tick):
        if any(got[k] != want.get(k, 0) for k in got):
            raise AssertionError(f"{what}: tick {t} launched {got}, expected {want}")


def _finite(outs, what: str) -> None:
    for t, xs in enumerate(outs):
        if not all(torch.isfinite(x).all() for x in xs):
            raise AssertionError(f"{what}: tick {t} outputs not finite")


def ring_on_engine_data(state, t: float) -> dict:
    """K4 against its plain version on the rings the engine wrote, at each
    scale, at the state's slot. Whether the limits also reject zeros, T=1
    and a slot-blind kernel on these rings is reported, not required: the
    mapped features of noise frames through random weights are nearly the
    same in every frame and position (the kernel phase's random rows carry
    that proof)."""
    worst = {"max_abs_err": 0.0, "rel_err": 0.0, "limits_reject": True}
    for ring in state.feat_rings:
        n, s, h, w, c = ring.shape
        res = check_ring(ring.reshape(n, s, h * w, c), t, s // 2, state.slot)
        if not res["agrees"]:
            raise AssertionError(f"K4 disagrees with its plain version on the "
                                 f"engine's {ring.dtype} rings: {res}")
        worst = {"max_abs_err": max(worst["max_abs_err"], res["max_abs_err"]),
                 "rel_err": max(worst["rel_err"], res["rel_err"]),
                 "limits_reject": worst["limits_reject"] and res["limits_reject"]}
    return {"ring_dtype": str(state.feat_rings[0].dtype).replace("torch.", ""),
            "streams": state.feat_rings[0].shape[0], "slot": state.slot, **worst}


def serving_parity(weights, defs, dev) -> dict:
    """At 4 streams in fp32 (TF32 off) the same engine on the card and on
    the CPU, tick by tick, in each correspondence mode and with int8 rings:
    raw and fused boxes and scores within SERVE_TOL, and the decoded index
    of the center prediction (eval_features on the tick's rings) equal;
    after n_frame ticks the card's raw box and score with float rings equal
    eval_clip's on the same 5 frames within the CPU test's limits (int8
    rings quantise what eval_clip keeps in float: their gap is reported);
    K4 on the card's fp32 rings against its plain version."""
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.ops.decode import decode_best
    from dcnet_tpu_torch.serving.engine import GroundingEngine

    cfg32 = serving_config(compute_dtype="float32")
    rng = np.random.RandomState(4)
    size = cfg32.image_size
    frames = rng.rand(PARITY_TICKS, PARITY_STREAMS, size, size, 3).astype(np.float32)
    ids = _phrases(rng, cfg32, PARITY_STREAMS)
    cpu = torch.device("cpu")
    res, on_data = {}, None
    for mode in ("k1", "multiref", "multiref_int8"):
        cfg = cfg32.replace(coattn_multiref=mode != "k1")
        engines = {}
        for role, where in (("card", dev), ("cpu", cpu)):
            m = DCNet(cfg, backbone_defs=defs, device=where)
            m.load_state_dict({k: v.to(where) for k, v in weights.items()})
            engines[role] = GroundingEngine(
                m, PARITY_STREAMS, int8_rings=mode.endswith("int8"))
        states = {k: e.init_state(ids) for k, e in engines.items()}
        worst, same_idx = 0.0, True
        t0 = time.perf_counter()
        for t in range(PARITY_TICKS):
            got = {}
            for k, e in engines.items():
                states[k], *outs = e.step(states[k], torch.from_numpy(frames[t]))
                st = states[k]
                out = e.model.eval_features(st.feat_rings, st.word_ids,
                                            language=st.language,
                                            newest_slot=st.slot)
                got[k] = ([x.cpu() for x in outs], decode_best(out.outbox, cfg))
            for a, b in zip(got["card"][0], got["cpu"][0]):
                torch.testing.assert_close(a, b, **SERVE_TOL)
                worst = max(worst, (a - b).abs().max().item())
            same_idx = same_idx and all(
                torch.equal(getattr(got["card"][1], f).cpu(), getattr(got["cpu"][1], f))
                for f in ("best_n", "gi", "gj", "scale"))
            if t == cfg.n_frames_test - 1:  # streaming against offline
                card = engines["card"]
                clip = torch.from_numpy(frames[:5].transpose(1, 0, 2, 3, 4).reshape(
                    -1, size, size, 3)).to(dev)
                dec = decode_best(card.model.eval_clip(clip, ids.to(dev)).outbox, cfg)
                raw, score = got["card"][0][1], got["card"][0][2]
                want_box, want_score = dec.boxes[:, 0].cpu(), dec.score[:, 0].cpu()
                offline = {"box_max_abs": (raw - want_box).abs().max().item(),
                           "score_max_abs": (score - want_score).abs().max().item(),
                           "held": not mode.endswith("int8")}
                if offline["held"]:
                    torch.testing.assert_close(raw, want_box, **OFFLINE_BOX_TOL)
                    torch.testing.assert_close(score, want_score, **OFFLINE_SCORE_TOL)
        if not same_idx:
            raise AssertionError(f"serving {mode}: decoded indices differ "
                                 f"between the card and the CPU")
        res[mode] = {"max_abs_err": worst, "same_decoded_index": same_idx,
                     "offline_eval_clip": offline,
                     "seconds": time.perf_counter() - t0}
        if mode == "multiref":
            on_data = ring_on_engine_data(states["card"], cfg.coattn_temperature)
        del engines, states
    kernels.reset_launches()  # the parity runs and comparisons do not count
    return {"streams": PARITY_STREAMS, "ticks": PARITY_TICKS, "tol": SERVE_TOL,
            "offline_tol": {"box": OFFLINE_BOX_TOL, "score": OFFLINE_SCORE_TOL},
            "modes": res, "k4_on_fp32_rings": on_data}


def phase_serving(dev, profile_dir=None) -> dict:
    """The serving path on the card: the full-width model, cast for
    serving, in bf16 at 120 streams through GroundingEngine."""
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.serving.engine import GroundingEngine, cast_params_for_serving

    cfg = serving_config(compute_dtype="bfloat16", coattn_multiref=True)
    size, n = cfg.image_size, SERVE_STREAMS
    model, defs, setup_s = seeded_model(cfg, dev)
    cast_params_for_serving(model)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    k1_model = DCNet(cfg.replace(coattn_multiref=False), backbone_defs=defs, device=dev)
    k1_model.load_state_dict(weights)
    rng = np.random.RandomState(3)
    ids, swap_ids = _phrases(rng, cfg, n).to(dev), _phrases(rng, cfg, n).to(dev)
    swap_mask = np.arange(n) % 3 == 0
    gen = torch.Generator(device=dev).manual_seed(3)

    def frames_at(_t):
        return torch.rand((n, size, size, 3), generator=gen, device=dev)

    # --- the main path: multiref, float rings, a query swap mid-run --------
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, per_tick, outs = _serve(GroundingEngine(model, n), ids, SERVE_TICKS,
                                   frames_at, swap=(SWAP_TICK, swap_ids, swap_mask))
    main_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    _expect_launches(per_tick, {"coattn_ring": 3}, "serving, multiref")
    _finite(outs, "serving, multiref")
    seen = state.frames_seen.cpu().numpy()
    if not ((seen == np.where(swap_mask, SERVE_TICKS - SWAP_TICK, SERVE_TICKS)).all()
            and state.feat_rings[0].dtype == torch.bfloat16):
        raise AssertionError(f"serving state after the swap: frames_seen {seen}")
    on_data = {"bfloat16": ring_on_engine_data(state, cfg.coattn_temperature)}
    del state

    # --- the default K1 path and int8 rings ---------------------------------
    kernels.reset_launches()
    state, per_tick, outs = _serve(GroundingEngine(k1_model, n), ids, 6, frames_at)
    _expect_launches(per_tick, {"coattn_attend": 12}, "serving, default K1 path")
    _finite(outs, "serving, default K1 path")
    k1_on_data = {"streams": n, "slot": state.slot, **check_k1_on_frames(
        state.feat_rings, cfg.coattn_temperature, state.slot)}
    del state
    kernels.reset_launches()
    state, per_tick, outs = _serve(GroundingEngine(model, n, int8_rings=True), ids,
                                   6, frames_at)
    _expect_launches(per_tick, {"coattn_ring": 3}, "serving, multiref int8 rings")
    _finite(outs, "serving, multiref int8 rings")
    if state.feat_rings[0].dtype != torch.int8:
        raise AssertionError("int8_rings engine wrote non-int8 rings")
    on_data["int8"] = ring_on_engine_data(state, cfg.coattn_temperature)
    del state
    kernels.reset_launches()

    parity = serving_parity(weights, defs, dev)

    # --- s/tick at 120 streams, bf16: median of timed chains ----------------
    timing = {}
    for name, eng in (("multiref", GroundingEngine(model, n)),
                      ("multiref_int8_rings", GroundingEngine(model, n, int8_rings=True)),
                      ("k1", GroundingEngine(k1_model, n))):
        frames = frames_at(0)
        state = eng.init_state(ids)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(WARMUP_TICKS):
            state, *_ = eng.step(state, frames)
        chains = []
        for _ in range(TIMED_CHAINS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(CHAIN_TICKS):
                state, fused, raw, score = eng.step(state, frames)
            torch.cuda.synchronize()
            chains.append((time.perf_counter() - t1) / CHAIN_TICKS)
        med = float(np.median(chains))
        timing[name] = {"streams": n, "s_per_tick": med, "s_per_tick_chains": chains,
                        "predictions_per_s": n / med,
                        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        if profile_dir:
            try:  # a diagnostic: a profiler that cannot trace is reported
                timing[name]["profile"] = profile_call(
                    lambda: eng.step(state, frames), profile_dir,
                    f"serving_tick_{name}_bf16")
            except Exception as e:  # noqa: BLE001
                timing[name]["profile"] = {"error": repr(e)[:300]}
        del state, eng
    kernels.reset_launches()
    rec = {"phase": "serving", "model": "YOLOv3/Darknet-53 + BiLSTM, 256 px, "
           "emb 512, hidden 512, corpus 1000, n_frame 5, topk 5, fuse_window 5, "
           "rotating rings, split_corr_conv off, bf16, cast_params_for_serving",
           "setup_s": setup_s, "streams": n, "ticks": SERVE_TICKS,
           "query_swap": {"tick": SWAP_TICK, "streams": int(swap_mask.sum())},
           "main_path_s": main_s, "launches": launches,
           "launches_per_tick": {"multiref": {"coattn_ring": 3, "coattn_attend": 0},
                                 "k1": {"coattn_attend": 12, "coattn_ring": 0},
                                 "multiref_int8_rings": {"coattn_ring": 3}},
           "k4_on_engine_rings": on_data, "k1_on_engine_rings": k1_on_data,
           "cpu_parity": parity,
           "timing": timing, "kind": torch.cuda.get_device_name(dev),
           "nvidia_smi": nvidia_smi()}
    emit(rec)
    return rec


def profile_call(fn, out_dir, tag) -> dict:
    """torch.profiler over one call of fn: device time by kernel (top
    entries), summed kernel time, the host wall time of the call and their
    ratio (the device's busy share). The full table goes to `out_dir`."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []  # kernels only: operator rows would count their kernels twice
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.self_device_time_total > 0:
            rows.append((e.self_device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{tag}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))
    return {"wall_ms": wall_ms, "device_ms": total_ms,
            "device_busy_share": total_ms / wall_ms if wall_ms else None,
            "top": [{"name": k[:80], "ms": us / 1e3, "calls": n}
                    for us, k, n in rows[:12]]}


KERNELS = (  # name, path it runs on, source, the TPU kernel it replaces
    ("coattn_attend", "eval", "dcnet_tpu_torch/csrc/coattn.cu",
     "dcnet_tpu/ops/pallas/coattn.py:52 (_attend; body _attend_kernel :40)"),
    ("coattn_pair", "train", "dcnet_tpu_torch/csrc/coattn.cu",
     "dcnet_tpu/ops/pallas/coattn.py:170 (coattention_fused; custom_vjp "
     ":179-193; wrapper coattention_pair_fused :371)"),
    ("coattn_attend_bwd", "train", "dcnet_tpu_torch/csrc/coattn_bwd.cu",
     "dcnet_tpu/ops/pallas/coattn.py:121 (_attend_bwd; body "
     "_attend_bwd_kernel :80; wired by _bwd :183 and _one_bwd :215)"),
    ("coattn_ring", "serving", "dcnet_tpu_torch/csrc/coattn_ring.cu",
     "dcnet_tpu/ops/pallas/coattn.py:267 (coattention_ring; body "
     "_ring_attend_kernel :240; dispatch :334)"),
    ("loc_gram", None, "dcnet_tpu_torch/csrc/locgram.cu",
     "dcnet_tpu/ops/pallas/locgram.py:49 (fused_loc_gram; body _kernel :35; "
     "fold_dense_bn :91)"),
)


def _headline(name: str, case: dict) -> bool:
    """The case a kernel's entry reports: K1-K4 at P=1024, C=512, bf16 (B=8
    for K1's eval request, B=16 for the train step's K2 and K3, B=120
    streams for K4); K5 at B=8, P=1344, fp32 ce (the fp32 eval trunk's)."""
    if name == "loc_gram":
        return (case["B"] == 8 and case["P"] == LOC_P and case["E"] == LOC_E
                and case["C"] == KERNEL_C and case["dtype"] == "float32")
    return (case["P"] == max(MAIN_P) and case["C"] == KERNEL_C
            and case["dtype"] == "bfloat16")


def kernels_line(cases: list, launches: dict) -> dict:
    """One entry per kernel: headline numbers (`_headline`), every case
    under `cases`. `launches` are the counts of the path each kernel runs
    on (eval for K1, train for K2 and K3, serving for K4); K5 runs on no
    path (`"path": null`) and reports its kernel-phase launches. Each
    entry's "timer" names what its "ms", "plain_ms" and "library_ms"
    measure (`TIMERS`)."""
    out = []
    for name, path, source, replaces in KERNELS:
        mine = [c for c in cases if c["name"] == name]
        head = next(c for c in mine if _headline(name, c))
        worst = max(c["max_abs_err"] for c in mine
                    if c["dtype"] == head["dtype"] and c["C"] == head["C"])
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "path": path, "launches": launches[name],
            "shape": {"B": head["B"], "P": head["P"], "C": head["C"],
                      "dtype": head["dtype"]},
            "max_abs_err": worst, "timer": head["timer"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "bodies": sorted({c["body"] for c in mine if c.get("body")}),
            "cases": [{k: c.get(k) for k in ("dtype", "B", "P", "C", "E", "body",
                                             "max_abs_err", "rel_err", "ms",
                                             "call_ms", "plain_ms", "library_ms",
                                             "rank8_route_ms", "bound_ms",
                                             "bound_by", "library_backends")}
                      for c in mine]})
    return {"kernels": out, "timers": TIMERS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default="",
                    help="directory for torch.profiler tables of one "
                         "eval_clip and one train_step per dtype and one "
                         "serving tick per mode")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    info = phase_device(dev)
    phase_build()
    cases, k5_launches = phase_kernel(dev)
    eval_launches = phase_slice(dev, profile_dir=args.profile)["launches"]
    train_launches = phase_train(dev, profile_dir=args.profile)["launches"]
    serving_launches = phase_serving(dev, profile_dir=args.profile)["launches"]
    on_paths = {"coattn_attend": eval_launches["coattn_attend"],
                "coattn_pair": train_launches["coattn_pair"],
                "coattn_attend_bwd": train_launches["coattn_attend_bwd"],
                "coattn_ring": serving_launches["coattn_ring"]}
    if not all(on_paths.values()):
        raise AssertionError(f"a kernel of the paths never launched: {on_paths}")
    if not k5_launches:
        raise AssertionError("K5 never launched in the kernel phase")
    launches = {**on_paths, "loc_gram": k5_launches}
    emit(kernels_line(cases, launches))
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
