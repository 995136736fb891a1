"""Drives the PyTorch/CUDA port (`dcnet_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --profile DIR   # and torch.profiler tables of
                                          # eval_clip, train_step and a
                                          # serving tick, each holding
                                          # K1-K6's launches by kernel
                                          # name against the counters
    python3 chip_smoke.py --cli-pace      # device and build phases, then
                                          # only the eval CLI's pace over
                                          # longer splits, numpy and the
                                          # C++ host loader (phase_cli_pace)
    python3 chip_smoke.py --only export,serve_cli
                                          # device and build phases, then
                                          # only the named phases

Phases, each printing JSON lines, any failure exiting non-zero:
  1. device  -- the card (nvidia-smi name and power limit), torch/CUDA
     versions, the image decoders installed (cv2, PIL, torchvision), the C++
     host loader's build (g++ at first use: its formats, the jpeglib.h and
     opencv4 headers found, ldconfig's jpeg / opencv libraries, g++'s
     version, the build's seconds); TF32 is switched off for matmuls and
     cuDNN convolutions.
  2. build   -- compiles every kernel from `dcnet_tpu_torch/csrc/` with nvcc,
     one process per source, all started together; prints ptxas's register
     and spill lines (and the spill bytes per library), and the counts of
     HGMMA (wgmma) and UTMALDG (TMA load) instructions in the coattn and
     coattn_ring libraries and of tensor-core instructions with a TF32
     operand (HMMA or HGMMA ... TF32) in coattn, coattn_bwd and coattn_ring
     (cuobjdump -sass), failing if any is 0; and in the kernel functions of
     K4's int8 block alone, integer wgmma (IGMMA) for the logits, HGMMA for
     PV and UTMALDG, failing if one is 0 or any IMMA is there; and K6's
     main route (conv_s8_tma) integer wgmma (IGMMA) and UTMALDG, failing at
     0 or on any IMMA; in the three per-type libraries (int8, bf16 and fp32
     inputs), kernel by kernel, IGMMA and UTMALDG in the halo route's
     kernel (failing at 0 or on any IMMA there) and the int8 mma.sync
     products (IMMA) of the gather route's, failing at 0. The SASS dumps
     run in parallel; K6's four
     libraries build and are dumped in the
     background while the kernel phase runs K1-K5; that phase waits for
     them (and checks them) before K6's cases.
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
     528, K3's general pass. Then K6 (the int8 convolution, no TPU
     kernel): every distinct conv shape of the YOLOv3 backbone on 8 frames
     of 256 px and the trunk's at P=1024, in every epilogue mode (int32,
     fp32 / bf16 with leaky, the int8 chain, the trunk's BN + ReLU, float
     inputs quantized on load), bitwise against its plain version, and on
     the thin shapes (the halo route's) PR 9's gather kernel too, in every
     mode; a dropped k-tile, a dropped tile of the halo walk and a
     two-rounding scale are shown to fail that check;
     timed in bf16 out beside the plain version (at the headline shape),
     torch._int_mm (1x1) and cuDNN's bf16 convolution of the shape (a
     point of reference). The int8 and serving_int8 phases hold K6 again
     at the path's own shapes and modes (`HeldK6`).
  4. slice   -- the full-width 256 px model (YOLOv3 backbone from a seeded
     Darknet `.weights` file, the rest from a seeded torch.Generator)
     answers batches of 5-frame clips through eval_clip -> decode_best; the
     kernel launch counts of that run are checked (12 per eval_clip), the
     outputs are held against the same model run on the CPU, K1 is held
     against its plain version on the model's own mapped features in each
     compute dtype, K5 (with the folded loc_text_embedding) against the
     trunk's rank-8 route on the coord_emb and obj_map of one fp32
     eval_clip, and eval_clip is timed in float32 and bfloat16.
  4b. int8  -- the same model in bf16, its backbone quantized and its
     trunk calibrated on 20 seeded frames (`ops.quant`), answers requests
     through `quant_eval_clip` with the int8 chain (K6 per live conv and
     trunk conv, K1 12 a call) and with --coattn_int8 / --coattn_batch_refs
     (K1 0); every K6 call of those requests is held bitwise against its
     plain version on the same tensors (`HeldK6`); fp32 copies with the
     trunk PTQ on the card and the CPU agree (outbox atol 1e-2, decoded
     index equal, each trunk conv bitwise on the card's inputs); each
     timed at 64 clips beside the float bf16 eval_clip.
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
  5b. bert   -- the same model with the frozen BERT text encoder at
     bert-base-uncased's geometry (768 hidden, 12 layers, 12 heads, 3072,
     vocab 30522; seeded weights) and 20-token phrases of the offline
     fallback tokenizer: requests of 8 clips through eval_clip ->
     decode_best (K1 12 a call), card against CPU in fp32 (decoded index
     equal, outbox 1e-3), eval_clip timed at 64 clips in fp32 and bf16
     beside the BiLSTM model's (slice phase); train_epoch on 16 k=2 clips
     (K2 3 and K3 6 a step), the BERT body bytewise unchanged, proj, the
     backbone and the trunk moved; train_step timed in both dtypes beside
     the BiLSTM step (train phase).
  6. serving -- the same full-width model, cast for serving, in bf16 serves
     120 streams through GroundingEngine: with coattn_multiref (float rings,
     a query swap on a third of the streams mid-run; launches per tick K4 3,
     K1 0), the default K1 path (K1 12, K4 0) and int8 rings; outputs
     finite; at 4 streams in fp32 the engine on the card against the same
     engine on the CPU tick by tick in each mode, and against eval_clip
     after n_frame ticks; K4 against its plain version on the engine's own
     rings in each ring dtype, and K1 on the default path's rings at 120
     streams; s/tick, predictions/s and peak GiB per mode.
  6b. serving_int8 -- the same engine after `quantize()` (int8 backbone
     and trunk): 12 ticks at 120 streams in each mode, launches per tick
     checked, every K6 call of the last tick held bitwise against its
     plain version (`HeldK6`), timed; 4 fp32 streams card against CPU per
     tick: the int8 backbone alone boxes and scores 1e-3; with the trunk
     PTQ the decoded cell, box and score (`serve_cells_held`).
  7. cli     -- the port's eval CLIs called in-process on the card, with
     the split, the caches and ./logs under a temporary directory: the
     full-width model (Darknet-53 from a seeded `.weights` file through
     --backbone_weights, 256 px, --lstm, emb/hidden 512, 5-frame windows,
     batch 8) over a synthetic test split written first in .npy frames
     (4 videos x 9 frames, 16 windows), in fp32 and bf16, standard
     (`eval_clip`: K1 12 a call) and --stream_eval (`eval_features`: K1 12
     a call), whose acc@0.5 must equal the standard eval's (1e-6) and mIoU
     lie within 2e-3; the fp32 --cache held against the same CLI on the
     CPU (equal top-k order, scores rtol 1e-4 / atol 1e-5, boxes 1e-3 px);
     cli/post_process.py on that cache against --post_process;
     cli/eval_single.py (DCNet.single_image) on the card against the CPU;
     the committed tiny lock (tests/locks/converge32tiny.npz, --resume) over
     10 rows of the data/synthetic32 split regenerated in .npy frames, card
     against CPU, mIoU > 0.05; on the lock, --quant, --quant --quant_trunk,
     --coattn_int8 and --coattn_batch_refs card against CPU (acc 1e-6,
     mIoU 2e-3) and each within mIoU 0.03 / acc 0.11 of float. Wall time
     and clips/s per run (set-up dominates at 16 windows), and the host
     data path's time alone.
  7b. native -- the C++ host loader (`dcnet_tpu_torch.native`, built from
     the checkout's `native/host_loader.cc`): `decode_letterbox_batch` at
     256 px bitwise the numpy path (`read_image` -> `letterbox` ->
     `normalize_image`) on seeded .npy frames of 320x480, 720x1280, 13x999
     and a gray 240x320, the geometry equal, and on the same frames as .jpg
     against the cv2 path within 2/255 where JPEG is compiled in;
     `decode_batch_rgb` against `read_image`; ms a frame at 320x480 and
     720x1280 (numpy serially, the core on 1 thread and on min(16,
     cpu_count)); the cli phase's full-width fp32 standard eval (--cache)
     and --stream_eval over its 16 windows, --post_process, and the tiny
     lock's over 10 rows, with the core required (use_native=True),
     against the same runs under DCNET_NO_NATIVE: the printed lines equal,
     the full-width caches within the cli phase's limits (and whether
     bitwise), the lock's mIoU > 0.05, K1 12 a call, the core's calls
     above 0 (and 0 without it).
  8. train_cli -- cli/train.py in-process on the card at full width
     (Darknet-53 from a seeded `.weights` file, 256 px, emb 512) under a
     temporary directory, over a synthetic train split in .npy frames
     with augmentation on (4 videos x 6 frames, batch 4, --max_steps 2, 2
     epochs) and a test split for validate: a --lstm run and a
     bert-base-uncased run, each with K2 3 a train or validate step and
     K3 6 a train step, two `accu ... miou ...` lines and the checkpoints
     0.pth.tar and 1.pth.tar; a --lstm run of 1 epoch resumed with
     --resume to 2 ends as close to the uninterrupted run as a second
     uninterrupted run does (`RESUME_SPREAD`; bitwise where that repeats
     bitwise; cuDNN deterministic, torch's deterministic algorithms asked
     for with their warnings recorded);
     cli/test.py --resume on each run's checkpoint directory, card against
     CPU (acc 1e-6, mIoU 2e-3). s/step, the card's busy share over the
     --lstm run's epochs (torch.profiler) and the host data path's time
     per augmented clip.
  9. export -- the serving bundle (`serving/export.py`): the serving
     phase's bf16 model at 120 streams exported (torch.export, the slot a
     dynamic input, the kernels as `dcnet::` operators) as a float engine
     with int8 rings on K4, a float K1 engine, and after `quantize()`
     with int8 rings; the bundles loaded and served in a fresh process
     that imports no model module, 12 ticks on the live engine's seeded
     frames: raw and fused boxes and scores within 1e-4 of the live
     engine and the same launches every tick (K4 3, or K1 12; K6 95 and
     the quantize passes after `quantize()`); export and load seconds,
     s/tick beside the live engine's.
  10. serve_cli -- cli/serve.py in-process at full width (Darknet-53 from
     a seeded `.weights` file, 256 px, emb 512) on --synthetic streams of
     `.npy` frames: BiLSTM and BERT, float and --quant, 4 fp32 streams x 6
     ticks, card against CPU (float boxes and scores 1e-3 each tick;
     --quant by `serve_cells_held`), K1 12
     (and K6 95 after --quant) launches a tick; --state_file stopped at
     tick 3 and resumed against the uninterrupted run; --export_bundle;
     predictions/s at 16 streams, float and --quant.
  11. ddp -- a NCCL group of one on the card: one fp32 train step through
     DistributedDataParallel against the plain step from the same weights
     (bitwise, deterministic algorithms), and `cli/train.py --devices 1`
     against the plain run (within twice a repeated plain run's spread).
     Two cards cannot run on a one-card machine (the phase says so).
  12. mesh -- the 2-D (data, model) mesh (`parallel.mesh`, `cfg.tp_internals`,
     the engine's `mesh`): K1 (B=8), K2 and K3 (B=16) on row windows at P
     64, 256 and 1024, C=512, fp32 and bf16 (P/2 and P/4 at offset 0 and at
     the end, 37 rows at offset 11), each window against its plain version
     (K3 fp32 against float64), against the full launch's rows, a window
     shifted by one row rejected, K3's partial dkv over each partition
     summed against the whole frame's, device ms of the P/2 and P/4 launches
     beside the full one; a NCCL group of one with tp_internals (train step
     and eval_clip bitwise the plain ones, K2 3, K3 6, K1 12); two processes
     on the card joined by gloo over CUDA tensors: the (data 1, model 2)
     fp32 k=2 train step at full width against the one-process step by
     train_parity's rule (K2 3 and K3 6 on windows on each rank), eval_clip
     under it (K1 12 on windows), the (data 2, model 1) engine at 8 fp32
     streams over 8 ticks against the one-process engine (1e-4), its state
     file resumed in one process, and the bf16 multiref serving cell's
     s/tick per rank beside one process (no scaling measured on one card);
     `dryrun_multichip(4)` (4 gloo ranks on the card, a 2 x 2 mesh, the mini
     model at 64 px). Two cards cannot run here (the phase says so).
Then the seconds of each phase, the `kernels` line (K1's launches per
path, K2's and K3's per path), the nvidia-smi line, and
as the last line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import functools
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

try:
    import dcnet_tpu_torch  # noqa: F401
    # the kernel phase times every kernel with device_ms, beside cuda_ms
    from kernel_timing import TIMERS, cuda_ms, device_ms
except ImportError as e:  # run outside a checkout of the repository
    sys.exit(f"chip_smoke: cannot import dcnet_tpu_torch ({e}); run it from "
             f"the root of a checkout")

from dcnet_tpu_torch import kernels, native
from dcnet_tpu_torch.kernels import build
from dcnet_tpu_torch.kernels import coattn as k_coattn
from dcnet_tpu_torch.kernels import conv_s8 as k_conv
from dcnet_tpu_torch.kernels import locgram as k_locgram
from dcnet_tpu_torch.ops import correspondence
from dcnet_tpu_torch.utils import profiling

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


def _decoders() -> dict:
    """The image decoders this machine has (version, or None): the port
    reads .npy frames with numpy and decodes other files through cv2."""
    import importlib
    found = {}
    for name in ("cv2", "PIL", "torchvision"):
        try:
            found[name] = getattr(importlib.import_module(name), "__version__", "?")
        except ImportError:
            found[name] = None
    return found


def _run_text(cmd) -> str:
    """A probe command's output (stdout and stderr), or why it did not run."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                             shell=isinstance(cmd, str))
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"did not run: {e}"
    return (out.stdout + out.stderr).strip()


def native_probe() -> dict:
    """What the C++ host loader builds with here: the headers it looks for,
    the libraries ldconfig knows, g++'s version, and the formats, reason and
    seconds of its build (the first use, in this process)."""
    t0 = time.perf_counter()
    formats = native.formats()
    build_s = time.perf_counter() - t0
    return {"formats": list(formats), "unavailable_reason": native.unavailable_reason(),
            "build_s": build_s, "missing": dict(native._get().missing),
            "headers": {h: os.path.exists(h) for h in (
                "/usr/include/jpeglib.h", "/usr/include/opencv4",
                "/usr/local/include/jpeglib.h", "/usr/local/include/opencv4")},
            "ldconfig": _run_text("ldconfig -p | grep -E 'jpeg|opencv'").splitlines()[:40],
            "gxx": _run_text(["g++", "--version"]).splitlines()[:1],
            "compiler": native.compiler()}


def phase_device(dev) -> dict:
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "tf32": "off for matmuls and cuDNN convolutions (all phases)",
            "decoders": _decoders(), "host_loader": native_probe()}
    emit(info)
    return info


K15_SOURCES = ("coattn", "coattn_bwd", "coattn_ring", "locgram")
K6_SOURCES = k_conv.ALL_SOURCES
# TF32_MMA: tensor-core instructions with a TF32 operand (HMMA.1688.F32.TF32
# of mma.sync, or HGMMA ... TF32); IGMMA and UTMALDG: K6's main route (wgmma
# s8 on TMA tiles) and its halo route (wgmma s8 on TMA-loaded halo tiles),
# which the three per-type libraries build beside the gather route; IMMA:
# the int8 mma.sync products of the gather route (the thin shapes the halo
# route cannot map). `K6_SASS_BY_KERNEL` counts them kernel by kernel.
SASS_COUNTED = {"coattn": ("HGMMA", "UTMALDG", "TF32_MMA"),
                "coattn_ring": ("HGMMA", "UTMALDG", "TF32_MMA"),
                "coattn_bwd": ("TF32_MMA",),
                **{name: ("IGMMA", "UTMALDG", "IMMA") for name in k_conv.SOURCES.values()},
                k_conv.TMA_SOURCE: ("IGMMA", "UTMALDG")}
# K6's kernels in the per-type libraries (a fragment of the kernel's name):
# the instructions each must hold, and IMMA, which the halo kernel must not
K6_SASS_BY_KERNEL = {"conv_halo_kernel": ("IGMMA", "UTMALDG"), "conv_s8_kernel": ("IMMA",)}


def _has_op(line: str, op: str) -> bool:
    if op == "TF32_MMA":
        return "TF32" in line and ("HMMA" in line or "HGMMA" in line)
    return f" {op}" in line or f"\t{op}" in line


@functools.lru_cache(maxsize=None)
def _sass(name: str) -> list:
    """The lines of `cuobjdump -sass` (the toolkit's, beside nvcc) on the
    built library of `csrc/<name>.cu`, dumped once (each dump takes
    seconds)."""
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


def _print_build_lines(names) -> None:
    for name in names:
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if any(k in line for k in ("registers", "spill", "error", "wgmma",
                                       "setmaxnreg", "Performance")):
                print(f"[nvcc {name}] {line.strip()}", flush=True)


def phase_build() -> concurrent.futures.Future:
    """Builds K1-K5's libraries and checks their SASS; K6's four start at
    the same moment in a background thread, whose future is returned for
    `finish_k6_build`."""
    t0 = time.perf_counter()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    k6 = pool.submit(_build_and_dump, K6_SOURCES)
    pool.shutdown(wait=False)
    build.build(K15_SOURCES)
    k_coattn._lib()
    k_coattn._bwd_lib()
    k_coattn._ring_lib()
    k_locgram._lib()
    seconds = time.perf_counter() - t0
    _print_build_lines(K15_SOURCES)
    counted = [n for n in K15_SOURCES if n in SASS_COUNTED]
    with concurrent.futures.ThreadPoolExecutor(len(counted)) as dumps:
        list(dumps.map(_sass, counted))
    sass = {n: sass_counts(n, ops) for n, ops in SASS_COUNTED.items() if n in K15_SOURCES}
    # K4's int8 block: integer wgmma (IGMMA) for the logits, bf16 wgmma
    # (HGMMA) for PV, TMA loads, and no mma.sync integer product (IMMA)
    s8 = sass_counts("coattn_ring", ("IGMMA", "HGMMA", "UTMALDG", "IMMA"),
                     function="ring_s8_kernel")
    emit({"phase": "build", "kernels": list(K15_SOURCES),
          "seconds": round(seconds, 3),
          "nvcc_seconds": {k: round(build.BUILD_SECONDS[k], 3) for k in K15_SOURCES
                           if k in build.BUILD_SECONDS},
          "sass_instructions": sass, "sass_int8_block": s8,
          "spill_bytes": {k: spill_bytes(build.BUILD_LOG[k]) for k in K15_SOURCES
                          if k in build.BUILD_LOG}})
    if not all(v > 0 for counts in sass.values() for v in counts.values()):
        raise AssertionError(f"the co-attention libraries lack wgmma, TMA or "
                             f"TF32 tensor-core instructions: {sass}")
    if not (s8["IGMMA"] and s8["HGMMA"] and s8["UTMALDG"]) or s8["IMMA"]:
        raise AssertionError(f"K4's int8 block is not on wgmma s8 + bf16 "
                             f"wgmma + TMA alone: {s8}")
    return k6


def _build_and_dump(names) -> None:
    """Builds the named sources and dumps their SASS (`_sass`), one after
    the other: the background job of `phase_build`."""
    build.build(names)
    for name in names:
        _sass(name)


def finish_k6_build(k6: concurrent.futures.Future) -> None:
    """Waits for K6's background build (re-raising its failure), loads its
    four libraries and fails unless the TMA route's library and each
    per-type library's halo kernel hold integer wgmma (IGMMA) and TMA
    loads (UTMALDG) and no mma.sync product (IMMA), and each per-type
    library's gather kernel holds IMMA."""
    t0 = time.perf_counter()
    k6.result()
    for dtype in k_conv.SOURCES:
        k_conv._lib(dtype)
    k_conv._tma_lib()
    _print_build_lines(K6_SOURCES)
    sass = {n: sass_counts(n, SASS_COUNTED[n]) for n in K6_SOURCES}
    by_kernel = {n: {frag: sass_counts(n, ("IGMMA", "UTMALDG", "IMMA"), function=frag)
                     for frag in K6_SASS_BY_KERNEL} for n in k_conv.SOURCES.values()}
    emit({"phase": "build", "kernels": list(K6_SOURCES), "built_in_background": True,
          "waited_s": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": {k: round(build.BUILD_SECONDS[k], 3) for k in K6_SOURCES
                           if k in build.BUILD_SECONDS},
          "sass_instructions": sass, "sass_by_kernel": by_kernel,
          "spill_bytes": {k: spill_bytes(build.BUILD_LOG[k]) for k in K6_SOURCES
                          if k in build.BUILD_LOG}})
    wgmma_imma = [sass_counts(k_conv.TMA_SOURCE, ("IMMA",))["IMMA"]] + [
        counts["conv_halo_kernel"]["IMMA"] for counts in by_kernel.values()]
    held = all(counts[frag][op] > 0 for counts in by_kernel.values()
               for frag, ops in K6_SASS_BY_KERNEL.items() for op in ops)
    if not all(v > 0 for counts in sass.values() for v in counts.values()) or not held \
            or any(wgmma_imma):
        raise AssertionError(f"K6's libraries lack int8 tensor-core instructions or TMA "
                             f"loads, or its wgmma routes hold mma.sync: {sass} {by_kernel}")


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


# K6, the int8 convolution: every distinct conv shape of the full-width
# backbone on 8 frames of 256 px (`ops.quant.conv_shapes`) and the trunk's
# at P=1024 (8 x 32 x 32: corr_conv 1024 -> 512 and its 512 -> 512 halves,
# the fcn's 1032 -> 512, 3x3 512 -> 512, 1x1 512 -> 512 and 512 -> 256, the
# /8 mapping 256 -> 512); as (k, stride, pad, Ci, Co, input side). Each in
# every epilogue mode, held bitwise against the plain version. Timed in
# bf16 out (the eval headline's activations). The paths' own calls (40
# frames a request, 120 a tick, their real scales) are held by `HeldK6`.
K6_FRAMES = 8
K6_TICK_FRAMES = 120                    # the quantized tick's (120 streams)
K6_TRUNK = ((1, 1, 0, 1024, 512, 32), (1, 1, 0, 512, 512, 32), (1, 1, 0, 1032, 512, 32),
            (3, 1, 1, 512, 512, 32), (1, 1, 0, 512, 256, 32), (1, 1, 0, 256, 512, 32))
K6_HEADLINE = (3, 1, 1, 256, 512, 16)   # the /16 residual blocks' 3x3 (8 of them)
K6_HALO_HEADLINE = (3, 1, 32, 64, 128)  # the halo route's: the first residual's 3x3
K6_DROPPED_BYTES = 64                   # one k-tile of the reduction
FIRST_LAYER_CI = 3                      # the first layer reads the fp32 frames
K6_PATH_ROUTES = ("tma", "halo")        # the routes the int8 paths' calls must take


def k6_shapes() -> list:
    """(group, (k, stride, pad, Ci, Co, side)) of the kernel phase's K6 cases."""
    from dcnet_tpu_torch.ops.quant import conv_shapes
    full = sorted({c[1:] for c in conv_shapes(_defs(), 256)})
    return [("backbone", c) for c in full] + [("trunk", c) for c in K6_TRUNK]


def conv_bound(n: int, k: int, stride: int, pad: int, ci: int, co: int, side: int,
               out_dtype: torch.dtype, epilogue: bool = True, in_bytes: int = 1):
    """K6: 2 N Ho Wo k^2 Ci Co operations at the int8 rate (1,979 TOP/s);
    x (`in_bytes` an element), w (and the fp32 scale and bias) read once,
    the output written once."""
    ho = (side + 2 * pad - k) // stride + 1
    nbytes = (n * side * side * ci * in_bytes + co * k * k * ci
              + (8 * co if epilogue else 0) + n * ho * ho * co * itemsize(out_dtype))
    return bound(2.0 * n * ho * ho * k * k * ci * co, nbytes, PEAK_FLOPS[torch.int8])


def _k6_modes(gen, co: int, dev, x, w, stride: int, pad: int, xf) -> dict:
    """K6's modes on the path: raw int32 (the split corr_conv's shared
    half), fp32 and bf16 out with the backbone's leaky, the int8 chain's
    requantization (inv_out puts the largest |y| at code 100, so the codes
    span the int8 range), the trunk's two affines + ReLU; and a float input
    quantized on load: bf16 x * in_inv to bf16 out (the backbone's convs
    after a shortcut or route), fp32 x / in_scale with the trunk's
    epilogue. `x` is int8 and `xf` a bf16 map of the same shape."""
    scale = (torch.rand(co, generator=gen) * 1e-4).to(dev)
    bias = torch.randn(co, generator=gen).to(dev)
    s2 = (1 + 0.1 * torch.randn(co, generator=gen)).to(dev)
    b2 = torch.randn(co, generator=gen).to(dev)
    affine = dict(scale=scale, bias=bias)
    y = k_conv.conv_s8_plain(x, w, stride, pad, **affine, act="leaky",
                             out_dtype=torch.float32)
    inv = float(np.float32(100.0 / max(y.abs().max().item(), 1e-30)))
    in_inv = float(np.float32(100.0 / xf.float().abs().max().item()))
    in_scale = torch.tensor(1.0 / 100.0, device=dev) * xf.float().abs().max()
    return {"int32": {},
            "float32": dict(affine, act="leaky", out_dtype=torch.float32),
            "bfloat16": dict(affine, act="leaky", out_dtype=torch.bfloat16),
            "int8": dict(affine, act="leaky", out_dtype=torch.int8, inv_out=inv),
            "trunk_bf16": dict(affine, scale2=s2, bias2=b2, act="relu",
                               out_dtype=torch.bfloat16),
            "bf16_in": dict(affine, act="leaky", out_dtype=torch.bfloat16, in_inv=in_inv),
            "fp32_in_trunk": dict(affine, scale2=s2, bias2=b2, act="relu",
                                  out_dtype=torch.float32, in_scale=in_scale)}


def _k6_input(mode: str, x, xf):
    """The input a K6 mode reads: the bf16 map, its fp32 copy or the codes."""
    if mode == "bf16_in":
        return xf
    return xf.float() if mode == "fp32_in_trunk" else x


def k6_sums(xq, w, stride: int, pad: int, plan) -> tuple:
    """The plain int32 sums of the int8 input xq, and those a faulty K6
    would give (`faults`): leaving one k-tile of the reduction
    (K6_DROPPED_BYTES of k^2 Ci, from its middle) out; where the TMA plan
    splits the reduction, dropping split 1 (its (tap, channel box)
    iterations); on the halo route, skipping the walk's last tile (its
    output pixels zero)."""
    kdim = w[0].numel()
    start = (kdim // 2) // K6_DROPPED_BYTES * K6_DROPPED_BYTES
    w_drop = w.reshape(w.shape[0], -1).clone()
    w_drop[:, start:start + K6_DROPPED_BYTES] = 0
    acc = k_conv.conv_s8_acc_plain(xq, w, stride, pad)
    faults = {"dropped_k_tile": k_conv.conv_s8_acc_plain(xq, w_drop.reshape(w.shape), stride,
                                                         pad)}
    if plan.route == "tma" and plan.splits > 1:
        ci = w.shape[-1]
        w_split = w.reshape(w.shape[0], -1, ci).clone()
        for it in range(*plan.split_range(1)):
            tap, cb = divmod(it, plan.cblocks)
            w_split[:, tap, cb * plan.cbox:(cb + 1) * plan.cbox] = 0
        faults["dropped_split"] = k_conv.conv_s8_acc_plain(xq, w_split.reshape(w.shape),
                                                           stride, pad)
    if plan.route == "halo":
        hp = plan.halo
        img, oh, ow = hp.tile_origin(hp.tiles - 1)
        tile = acc.contiguous().clone()
        if hp.th == 1:   # 128 consecutive pixels of the flattened output
            tile.view(-1, acc.shape[-1])[ow:ow + hp.tw] = 0
        else:
            tile[img, oh:oh + hp.th, ow:ow + hp.tw] = 0
        faults["dropped_tile"] = tile
    return acc, faults


def k6_wrong(acc, faults: dict, epi: dict) -> dict:
    """What a faulty K6 would return: the epilogue on each of `k6_sums`'s
    faulty sums, and (with an epilogue) the scale applied as a multiply
    and an add, two roundings."""
    out = {name: k_conv.epilogue_plain(f, **epi) for name, f in faults.items()}
    if epi.get("scale") is not None:
        y = acc.float() * epi["scale"] + epi["bias"]
        if epi.get("scale2") is not None:
            y = y * epi["scale2"] + epi["bias2"]
        out["two_roundings"] = _epilogue_from_float(y, epi)
    return out


def _epilogue_from_float(y: torch.Tensor, epi: dict) -> torch.Tensor:
    """K6's activation and output steps on fp32 values y."""
    if epi.get("act") == "relu":
        y = torch.where(y > 0, y, torch.zeros_like(y))
    elif epi.get("act") == "leaky":
        y = torch.where(y >= 0, y, y * 0.1)
    if epi["out_dtype"] == torch.int8:
        return torch.clamp(torch.round(y * epi["inv_out"]), -127, 127).to(torch.int8)
    return y.to(epi["out_dtype"])


def _k6_plan_rec(plan) -> dict:
    if plan.route == "halo":
        hp = plan.halo
        return {"route": plan.route, "why": plan.why, "map": "pixels" if hp.kind == 0
                else "rows", "tile": [hp.th, hp.tw], "halo": [hp.hin, hp.win], "cp": hp.cp,
                "stages": hp.stages, "grid": hp.grid, "tiles": hp.tiles, "smem": hp.smem}
    return {"route": plan.route, "why": plan.why, "bn": plan.bn, "splits": plan.splits,
            "stages": plan.stages, "cbox": plan.cbox, "rect": [plan.bimg, plan.bh, plan.bw],
            "quant_pass": plan.quant_x, "pad_w": plan.pad_w}


def k6_gather(x, w, stride: int, pad: int, scale=None, bias=None, scale2=None, bias2=None,
              act=None, out_dtype=torch.int32, inv_out=None, in_inv=None, in_scale=None):
    """PR 9's mma.sync kernel (the gather route) on a shape the plan gives
    another route, with `conv_s8`'s epilogue arguments (no addend)."""
    plan = k_conv.plan_for(x, w, stride, pad, out_dtype)
    gather = k_conv.ConvPlan("gather", "run beside the plan's route", plan.ho, plan.wo)
    return k_conv._conv_gather(gather, x, w, stride, pad, (scale, bias, scale2, bias2), None,
                               1, 1, out_dtype, inv_out, act, in_inv, in_scale)


def _k6_timing(dev, gdev, frames: int, k, stride, pad, ci, co, side, w, epi,
               x=None, xf=None) -> dict:
    """K6 at `frames` frames timed on the device: bf16 in quantized to bf16
    out (the path's), int8 in to int32 out, the quantize pass alone, the
    mma.sync kernel (the gather route) in both modes, torch._int_mm (1x1
    stride 1) and cuDNN's bf16 convolution; with the bounds of both K6
    calls."""
    if x is None:
        x = torch.randint(-127, 128, (frames, side, side, ci), generator=gdev,
                          dtype=torch.int8, device=dev)
        xf = torch.randn(frames, side, side, ci, generator=gdev, device=dev).to(torch.bfloat16)
    plan = k_conv.plan_for(xf, w, stride, pad)
    big = frames * side * side * k * k * ci * co > 2e10
    iters = 5 if big else 20
    rec = {"frames": frames,
           "ms": device_ms(lambda: k_conv.conv_s8(xf, w, stride, pad, **epi), iters),
           "int32_ms": device_ms(lambda: k_conv.conv_s8(x, w, stride, pad), iters),
           "quant_ms": (device_ms(lambda: k_conv.quant_pass(xf, plan.cp, epi["in_inv"]), iters)
                        if plan.route == "tma" else None)}
    # the mma.sync kernel (the gather route) on the same inputs
    rec["gather_int32_ms"] = device_ms(lambda: k6_gather(x, w, stride, pad), iters)
    rec["gather_ms"] = device_ms(lambda: k6_gather(xf, w, stride, pad, **epi), iters)
    if ci < 64 or k * k * ci < 256:
        # a thin shape in the input types the paths feed it: int8 in (the
        # int8 chain) to bf16 out, and the first layer's fp32 frames
        out_epi = {a: v for a, v in epi.items() if a != "in_inv"}
        rec["int8_in_ms"] = device_ms(lambda: k_conv.conv_s8(x, w, stride, pad, **out_epi),
                                      iters)
        rec["gather_int8_in_ms"] = device_ms(lambda: k6_gather(x, w, stride, pad, **out_epi),
                                             iters)
        rec["int8_in_bound_ms"], _ = conv_bound(frames, k, stride, pad, ci, co, side,
                                                torch.bfloat16)
        if ci == FIRST_LAYER_CI:
            x32 = xf.float()
            rec["fp32_in_ms"] = device_ms(lambda: k_conv.conv_s8(x32, w, stride, pad, **epi),
                                          iters)
            rec["gather_fp32_in_ms"] = device_ms(lambda: k6_gather(x32, w, stride, pad, **epi),
                                                 iters)
            rec["fp32_in_bound_ms"], _ = conv_bound(frames, k, stride, pad, ci, co, side,
                                                    torch.bfloat16, in_bytes=4)
            del x32
    rec["library_ms"] = None
    if k == 1 and stride == 1:
        a2, b2 = x.reshape(-1, ci), w.reshape(co, ci).t()
        try:
            torch._int_mm(a2, b2)
            rec["library_ms"] = device_ms(lambda: torch._int_mm(a2, b2), iters)
        except RuntimeError:
            pass   # _int_mm wants K and N multiples of 8
    xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)
    wb = w.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    rec["cudnn_bf16_conv_ms"] = device_ms(
        lambda: torch.nn.functional.conv2d(xb, wb, None, stride, pad), iters)
    rec["bound_ms"], rec["bound_by"] = conv_bound(frames, k, stride, pad, ci, co, side,
                                                  torch.bfloat16, in_bytes=2)
    rec["int32_bound_ms"], _ = conv_bound(frames, k, stride, pad, ci, co, side, torch.int32,
                                          epilogue=False)
    rec["quant_bound_ms"] = (1e3 * frames * side * side * (2 * ci + plan.cp) / PEAK_BYTES
                             if plan.route == "tma" else None)
    del xb, wb
    return rec


def kernel_cases_k6(dev, gen) -> list:
    """K6 against its plain version, bitwise, at every shape of `k6_shapes`
    in every mode of `_k6_modes`; the check shown to reject a dropped
    k-tile in every mode, a dropped split where the plan splits the
    reduction, and two roundings in fp32 out (in bf16 and int8 out most
    one-unit fp32 differences round away: reported). Each case records the
    plan's route (`conv_plan`). Timed at 8 and at 120 frames (a tick), bf16
    in to bf16 out, beside the card's bound, int8 in to int32 out,
    torch._int_mm (1x1 stride-1 shapes it takes: int32 out, no epilogue;
    the library call), cuDNN's bf16 convolution of the same shape (a point
    of reference, not the same function) and, at the headline shape and 8
    frames, the plain version. The quantize pass (`conv_s8_quant`) is held
    bitwise against its plain version and timed alone, as cases of its
    own."""
    cases = []
    gdev = torch.Generator(device=dev).manual_seed(6)
    for group, (k, stride, pad, ci, co, side) in k6_shapes():
        t0 = time.perf_counter()
        x = torch.randint(-127, 128, (K6_FRAMES, side, side, ci), generator=gen,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (co, k, k, ci), generator=gen,
                          dtype=torch.int8).to(dev)
        xf = torch.randn(K6_FRAMES, side, side, ci, generator=gen).to(dev, torch.bfloat16)
        modes, equal, rejects = _k6_modes(gen, co, dev, x, w, stride, pad, xf), {}, {}
        plan = k_conv.plan_for(x, w, stride, pad)
        routes = {}
        sums = {}  # the plain version's steps, its sums once per quantized input
        # on a thin shape PR 9's gather kernel is held beside the halo route
        gather_equal, gather_before = {}, kernels.LAUNCHES["conv_s8_gather"]
        for mode, epi in modes.items():
            xin = _k6_input(mode, x, xf)
            routes[mode] = k_conv.plan_for(xin, w, stride, pad).route
            got = k_conv.conv_s8(xin, w, stride, pad, **epi)
            got_g = k6_gather(xin, w, stride, pad, **epi) if plan.route == "halo" else None
            out_epi = {a: v for a, v in epi.items() if a not in ("in_inv", "in_scale")}
            key = "int8" if xin is x else mode
            if key not in sums:
                xq = k_conv.quantize_plain(xin, epi.get("in_inv"), epi.get("in_scale"))
                sums[key] = k6_sums(xq, w, stride, pad, plan)
            want = k_conv.epilogue_plain(sums[key][0], **out_epi)
            torch.cuda.synchronize()
            equal[mode] = bool(torch.equal(got, want))
            if got_g is not None:
                gather_equal[mode] = bool(torch.equal(got_g, want))
            rejects[mode] = {name: not torch.equal(wrong, want)
                             for name, wrong in k6_wrong(*sums[key], out_epi).items()}
        gather_launches = kernels.LAUNCHES["conv_s8_gather"] - gather_before
        ok = (all(equal.values())
              and all(r["dropped_k_tile"] and r.get("dropped_split", True)
                      and r.get("dropped_tile", True) for r in rejects.values())
              and rejects["float32"]["two_roundings"])
        # the quantize pass (the TMA route's): bf16 x * in_inv (the timed
        # input), fp32 x / in_scale
        quant_eq = {}
        for mode in ("bf16_in", "fp32_in_trunk") if plan.route == "tma" else ():
            epi = modes[mode]
            xin = _k6_input(mode, x, xf)
            got_q = k_conv.quant_pass(xin, plan.cp, epi.get("in_inv"), epi.get("in_scale"))
            want_q = k_conv.quant_pass_plain(xin, plan.cp, epi.get("in_inv"),
                                             epi.get("in_scale"))
            torch.cuda.synchronize()
            quant_eq[mode] = bool(torch.equal(got_q, want_q))
        if plan.pad_w:
            quant_eq["int8_pad"] = bool(torch.equal(k_conv.quant_pass(x, plan.cp),
                                                    k_conv.quant_pass_plain(x, plan.cp)))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        # timed: bf16 activations quantized to bf16 out (the path's)
        epi = modes["bf16_in"]
        headline = group == "backbone" and (
            (k, stride, pad, ci, co, side) == K6_HEADLINE
            or (k, stride, ci, co, side) == K6_HALO_HEADLINE)
        timing = {K6_FRAMES: _k6_timing(dev, gdev, K6_FRAMES, k, stride, pad, ci, co, side,
                                        w, epi, x, xf)}
        call_ms = (cuda_ms(lambda: k_conv.conv_s8(xf, w, stride, pad, **epi), 20)
                   if headline else None)
        p_ms = (device_ms(lambda: k_conv.conv_s8_plain(xf, w, stride, pad, **epi), 5)
                if headline else None)
        qp_ms = (device_ms(lambda: k_conv.quant_pass_plain(xf, plan.cp, epi["in_inv"]), 5)
                 if plan.route == "tma" else None)
        t2 = time.perf_counter()
        timing[K6_TICK_FRAMES] = _k6_timing(dev, gdev, K6_TICK_FRAMES, k, stride, pad, ci, co,
                                            side, w, epi)
        t3 = time.perf_counter()
        head = timing[K6_FRAMES]
        ho = (side + 2 * pad - k) // stride + 1
        rec = {"phase": "kernel", "name": "conv_s8_halo" if plan.route == "halo" else "conv_s8",
               "group": group, "dtype": "bfloat16",
               "B": K6_FRAMES, "P": side * side, "C": ci, "k": k, "stride": stride,
               "Ci": ci, "Co": co, "side": side, "out_side": ho,
               "plan": _k6_plan_rec(plan), "routes": routes,
               "vec": k_conv.conv_vec(ci, x, w), "bitwise_equal": equal,
               "limits_reject": rejects, "max_abs_err": 0.0 if ok else None, "ok": ok,
               "timer": "device", "ms": head["ms"], "call_ms": call_ms,
               "int32_ms": head["int32_ms"], "gather_ms": head["gather_ms"],
               "gather_int32_ms": head["gather_int32_ms"],
               "plain_ms": p_ms,
               "library_ms": head["library_ms"],
               "library_call": "torch._int_mm(x (M, Ci), w (Ci, Co)): int32, no epilogue"
                               if head["library_ms"] is not None else None,
               "cudnn_bf16_conv_ms": head["cudnn_bf16_conv_ms"],
               "cudnn_bf16_conv": "F.conv2d in bf16 of the same shape: a point of "
                                  "reference, not the same function",
               "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
               "int32_bound_ms": head["int32_bound_ms"],
               f"at_{K6_FRAMES}": head, f"at_{K6_TICK_FRAMES}": timing[K6_TICK_FRAMES],
               "seconds": {"inputs_and_checks": round(t1 - t0, 3),
                           f"timing_{K6_FRAMES}": round(t2 - t1, 3),
                           f"timing_{K6_TICK_FRAMES}": round(t3 - t2, 3)}}
        emit(rec)
        if plan.route == "halo":  # no quantize pass; PR 9's kernel held beside it
            grec = k6_gather_rec(rec, gather_equal, gather_launches)
            emit(grec)
            if not ok or not grec["ok"]:
                raise AssertionError(f"K6 disagrees with its plain version or its check "
                                     f"misses a fault: {rec} {grec}")
            cases += [rec, grec]
            del x, xf, w
            continue
        if plan.route != "tma":  # no quantize pass on the gather route
            if not ok:
                raise AssertionError(f"K6 disagrees with its plain version or its check "
                                     f"misses a fault: {rec}")
            cases.append(rec)
            del x, xf, w
            continue
        qrec = {"phase": "kernel", "name": "conv_s8_quant", "group": group,
                "dtype": "bfloat16", "B": K6_FRAMES, "P": side * side, "C": ci, "k": k,
                "stride": stride, "Ci": ci, "Co": co, "side": side, "cp": plan.cp,
                "bitwise_equal": quant_eq, "ok": all(quant_eq.values()),
                "max_abs_err": 0.0 if all(quant_eq.values()) else None, "timer": "device",
                "ms": head["quant_ms"], "plain_ms": qp_ms, "library_ms": None,
                "bound_ms": head["quant_bound_ms"], "bound_by": "bytes",
                f"at_{K6_TICK_FRAMES}": {k_: timing[K6_TICK_FRAMES][k_]
                                         for k_ in ("quant_ms", "quant_bound_ms")}}
        emit(qrec)
        if not ok or not qrec["ok"]:
            raise AssertionError(f"K6 disagrees with its plain version or its check "
                                 f"misses a fault: {rec} {qrec}")
        cases += [rec, qrec]
        del x, xf, w
    return cases


def k6_gather_rec(rec: dict, equal: dict, launches: int) -> dict:
    """The case of PR 9's gather kernel at a thin shape, from the halo
    route's case `rec` of the same shape and inputs: its bitwise checks in
    every mode (`equal`), the rejects that do not depend on the walk (a
    dropped k-tile, two roundings), its launches in those checks, and its
    times from the same run beside the same plain version, bound and
    cuDNN call."""
    at = {}
    for frames in (K6_FRAMES, K6_TICK_FRAMES):
        t = rec[f"at_{frames}"]
        at[f"at_{frames}"] = {
            "frames": frames, "ms": t["gather_ms"], "int32_ms": t["gather_int32_ms"],
            **{k: t[k] for k in ("gather_int8_in_ms", "gather_fp32_in_ms", "bound_ms",
                                 "int8_in_bound_ms", "fp32_in_bound_ms", "int32_bound_ms",
                                 "cudnn_bf16_conv_ms") if k in t}}
    ok = bool(equal) and all(equal.values()) and rec["ok"]
    return {"phase": "kernel", "name": "conv_s8_gather",
            **{k: rec[k] for k in ("group", "dtype", "B", "P", "C", "k", "stride", "Ci", "Co",
                                   "side", "out_side", "vec", "timer",
                                   "plain_ms", "library_ms", "library_call",
                                   "cudnn_bf16_conv_ms", "cudnn_bf16_conv", "bound_ms",
                                   "bound_by", "int32_bound_ms")},
            "route": "gather (run beside the plan's halo route)", "bitwise_equal": equal,
            "limits_reject": {mode: {f: v for f, v in r.items() if f != "dropped_tile"}
                              for mode, r in rec["limits_reject"].items()},
            "launches": launches, "max_abs_err": 0.0 if ok else None, "ok": ok,
            "ms": rec[f"at_{K6_FRAMES}"]["gather_ms"],
            "int32_ms": rec[f"at_{K6_FRAMES}"]["gather_int32_ms"], **at}


def k6_mode(x: torch.Tensor, kw: dict) -> str:
    """A K6 call's mode in words: its input (type and quantization), the
    epilogue's steps and the output type."""
    names = {torch.int8: "int8", torch.bfloat16: "bf16", torch.float32: "fp32",
             torch.int32: "int32"}
    src = names[x.dtype] + ("*in_inv" if kw.get("in_inv") is not None else
                            "/in_scale" if kw.get("in_scale") is not None else "")
    steps = [src]
    if kw.get("addend") is not None:
        rep = kw.get("addend_rep", 1)
        steps.append("+addend" + (f" x{rep}" if rep > 1 else ""))
    if kw.get("scale") is not None:
        steps.append("fma" + (" fma" if kw.get("scale2") is not None else ""))
    if kw.get("act"):
        steps.append(kw["act"])
    return " ".join(steps) + " -> " + names[kw.get("out_dtype", torch.int32)]


class HeldK6:
    """Holds every K6 call a path makes against its plain version on the
    same tensors on the card, bitwise, as each call returns: inside the
    `with`, `conv_s8` is replaced where the path calls it (`models.heads`,
    the trunk; `ops.quant`, the backbone) by a wrapper that launches the
    kernel as before and, while `active`, computes `conv_s8_plain` beside
    it. The plain computations launch no kernel, so the path's counts are
    those of its own calls. Every call, held or not, is planned
    (`conv_plan`): the routes the plan picks, and the quantize passes it
    asks for (`quant_passes`: x's, and w's where w keeps no padded copy
    yet; to hold `conv_s8_quant`'s count against).
    `summary` fails on any difference, on no held call, on a route the
    plan picked that no held call took, or on a route in `need` that no
    held call took, and gives the held calls by mode and by route and the
    distinct shapes."""

    def __init__(self):
        self.active, self.calls, self.modes, self.shapes, self.bad = True, 0, {}, set(), []
        self.routes_picked, self.routes_held, self.quant_passes = {}, {}, 0

    def __enter__(self):
        from dcnet_tpu_torch.models import heads
        from dcnet_tpu_torch.ops import quant
        self._saved = [(mod, mod.conv_s8) for mod in (heads, quant)]
        for mod, _ in self._saved:
            mod.conv_s8 = self._call
        return self

    def __exit__(self, *exc) -> bool:
        for mod, fn in self._saved:
            mod.conv_s8 = fn
        return False

    def _call(self, x, w, stride: int = 1, pad: int = 0, **kw):
        plan = k_conv.plan_for(x, w, stride, pad)
        route = plan.route + (" after the quantize pass" if plan.quant_x else "")
        self.routes_picked[route] = self.routes_picked.get(route, 0) + 1
        if plan.route == "tma":
            self.quant_passes += plan.quant_x + (plan.pad_w and k_conv.pad_w_due(w, plan.cp))
        out = k_conv.conv_s8(x, w, stride, pad, **kw)
        if self.active:
            want = k_conv.conv_s8_plain(x, w, stride, pad, **kw)
            mode = k6_mode(x, kw)
            self.calls += 1
            self.modes[mode] = self.modes.get(mode, 0) + 1
            self.routes_held[route] = self.routes_held.get(route, 0) + 1
            self.shapes.add((tuple(x.shape), tuple(w.shape), stride, pad))
            if not torch.equal(out, want):
                self.bad.append({"mode": mode, "route": route, "x": list(x.shape),
                                 "w": list(w.shape), "stride": stride, "pad": pad,
                                 "max_abs_err": (out.double() - want.double()).abs().max().item()})
        return out

    def summary(self, what: str, need=()) -> dict:
        unheld = sorted(set(self.routes_picked) - set(self.routes_held))
        missing = [r for r in need if not any(h.split()[0] == r for h in self.routes_held)]
        if self.bad or not self.calls or unheld or missing:
            raise AssertionError(f"{what}: K6 differs from its plain version on the path's "
                                 f"own calls ({len(self.bad)} of {self.calls}): {self.bad[:5]}"
                                 f"; routes picked but never held: {unheld}; routes the "
                                 f"path must take but no held call took: {missing}")
        return {"calls": self.calls, "distinct_shapes": len(self.shapes),
                "modes": dict(sorted(self.modes.items())),
                "routes_held": dict(sorted(self.routes_held.items())),
                "routes_picked": dict(sorted(self.routes_picked.items())),
                "quant_passes": self.quant_passes, "bitwise_equal": True}


def phase_kernel(dev, k6_build: concurrent.futures.Future):
    """K1-K6 against their plain versions on the card (K6 once its
    background build is done, `finish_k6_build`); returns the case records
    and the launches of the kernels that run on no path, those of the
    kernel phase's checked calls: K5's (one a case) and PR 9's gather
    kernel's (one a mode at each thin shape)."""
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
    finish_k6_build(k6_build)
    cases += kernel_cases_k6(dev, gen)
    kernels.reset_launches()  # the comparison launches above do not count
    off_path = {"loc_gram": k5_launches,
                "conv_s8_gather": sum(c["launches"] for c in cases
                                      if c["name"] == "conv_s8_gather")}
    return cases + k5_cases, off_path


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
            try:  # the profile or its error; one that stays lossy fails main
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


# --- the int8 eval path ------------------------------------------------------

INT8_CALIB_CLIPS = 4              # 20 calibration frames, the trunk on them
INT8_PARITY_CLIPS = 1
INT8_PARITY_TICKS = 5             # the quantized engine, card against CPU
# The int8 eval, card against CPU in fp32 (TF32 off), the same qparams and
# trunk scales. The int8 backbone is bitwise on both (K6 equals its plain
# version). With the trunk PTQ each trunk conv quantizes its input again,
# and inputs that differ by a few units in the last place (K1's 3xTF32
# against the plain fp32 softmax, other reduction orders) land on the other
# side of a rounding boundary for a few codes: one code moves a conv output
# by s_in s_w |w| ~ 1e-3 here, so the limit is atol 1e-2 (the first chip
# run saw 27 of 1,920 outbox elements past 1e-3, the largest 2.3e-3); each
# trunk conv on the card's own inputs is bitwise equal to the CPU's, and the
# decoded indices are equal in both.
INT8_PARITY_TOL = dict(rtol=0.0, atol=1e-2)


def int8_parity(card, cpu, cfg, tol: dict) -> dict:
    """The card's outputs against the CPU's at `tol`, decoded indices equal."""
    from dcnet_tpu_torch.ops.decode import decode_best
    err = max((g.cpu() - r).abs().max().item() for g, r in zip(card.outbox, cpu.outbox))
    past = sum(int(((g.cpu() - r).abs() > 1e-3).sum()) for g, r in zip(card.outbox, cpu.outbox))
    for g, r in zip(card.outbox, cpu.outbox):
        torch.testing.assert_close(g.cpu(), r, **tol)
    got, want = decode_best(card.outbox, cfg), decode_best(cpu.outbox, cfg)
    same_idx = all(torch.equal(getattr(got, f).cpu(), getattr(want, f))
                   for f in ("best_n", "gi", "gj", "scale"))
    if not same_idx:
        raise AssertionError("int8 decoded boxes differ between the card and the CPU")
    return {"max_abs_outbox_err": err, "outbox_elements_past_1e-3": past,
            "elements": sum(g.numel() for g in card.outbox), **tol,
            "same_decoded_index": same_idx}


class _capture_trunk_convs:
    """Record every trunk ConvBNReLU call's input and output (the int8
    modes) of `model`, by forward hooks, until close() (which returns
    [(module name, input, output)])."""

    def __init__(self, model):
        from dcnet_tpu_torch.ops.quant import _trunk_convs
        names = {id(m): n for n, m in model.named_modules()}
        self.calls, self.handles = [], []
        for mod in _trunk_convs(model).values():
            self.handles.append(mod.register_forward_hook(
                lambda m, args, out: self.calls.append((names[id(m)], args[0], out))))

    def close(self) -> list:
        for h in self.handles:
            h.remove()
        return self.calls


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    return x


def _trunk_convs_on_cpu(cpu_model, calls: list) -> dict:
    """Each trunk int8 conv of the CPU model on the card's own inputs
    against the card's output: bitwise (K6 and its plain version, the
    same quantization arithmetic)."""
    mods = dict(cpu_model.named_modules())
    bad = []
    for name, x, out in calls:
        want = mods[name](_to(x, torch.device("cpu")))
        got = _to(out, torch.device("cpu"))
        pairs = zip(got, want) if isinstance(want, list) else [(got, want)]
        if not all(torch.equal(g, w) for g, w in pairs):
            bad.append(name)
    if bad or not calls:
        raise AssertionError(f"trunk int8 convs differ between the card and the CPU on "
                             f"the card's inputs: {bad} of {len(calls)} calls")
    return {"calls": len(calls), "bitwise_equal": True}


def trunk_k6_per_call(cfg, references: int = 4) -> int:
    """K6 launches of the int8 trunk per eval_features call: mapping_visu
    3; corr_conv per scale 1 + R with the split list, 2 with stacked
    references (coattn_batch_refs), R without the split; the fcn 4 (light
    1) per scale."""
    if not cfg.split_corr_conv:
        corr = references
    else:
        corr = 2 if (cfg.coattn_batch_refs or cfg.coattn_multiref) else 1 + references
    return 3 + 3 * corr + 3 * (1 if cfg.light else 4)


def backbone_k6_per_call() -> int:
    """K6 launches of the int8 backbone a call: one per live conv."""
    from dcnet_tpu_torch.ops.quant import conv_layer_ids, live_layers
    live = live_layers(_defs())
    return sum(1 for i in conv_layer_ids(_defs()) if i in live)


def _to_cpu(qparams: dict) -> dict:
    return {i: {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in d.items()}
            for i, d in qparams.items()}


def phase_int8(dev, profile_dir=None) -> dict:
    """The int8 eval path on the card: the full-width model in bf16 with
    seeded weights, its backbone quantized on a seeded calibration batch
    (`quantize_model_backbone`) and its trunk calibrated on a float
    eval_clip of the same clips (`calibrate_trunk`), as the JAX eval bench
    does; then `quant_eval_clip` with the int8 chain (the JAX eval
    headline), and the --coattn_int8 and --coattn_batch_refs variants.
    Launches per call checked; fp32 copies on the card and the CPU (TF32
    off) agree; each variant timed at 64 clips beside the float bf16
    eval_clip of the same weights."""
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.ops import quant as Q
    from dcnet_tpu_torch.ops.decode import decode_best

    cfg = full_width_config().replace(compute_dtype="bfloat16")
    size, n_frame = cfg.image_size, 5
    model, defs, setup_s = seeded_model(cfg, dev)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(8)

    def request(clips):
        images = rng.rand(clips * n_frame, size, size, 3).astype(np.float32)
        ids = rng.randint(1, cfg.corpus_size, (clips, cfg.query_len))
        ids[:, 12:] *= rng.rand(clips, cfg.query_len - 12) < 0.5  # padding
        return torch.from_numpy(images).to(dev), torch.from_numpy(ids).to(dev)

    t0 = time.perf_counter()
    calib_images, calib_ids = request(INT8_CALIB_CLIPS)
    qparams = Q.quantize_model_backbone(model, calib_images)
    scales = Q.calibrate_trunk(model, lambda m: m.eval_clip(calib_images, calib_ids,
                                                              n_frame=n_frame))
    Q.trunk_quant_variant(model, "int8")
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    base = model.cfg
    variants = {"int8_chain": (dict(), True), "coattn_int8": (dict(coattn_int8_logits=True), True),
                "coattn_batch_refs": (dict(coattn_batch_refs=True), True)}
    bb = backbone_k6_per_call()

    def run(name, images, ids):
        over, chain = variants[name]
        model.cfg = base.replace(**over)
        try:
            return Q.quant_eval_clip(model, qparams, images, ids, n_frame, int8_chain=chain)
        finally:
            model.cfg = base

    # --- the main path: 3 requests of 8 clips, then each variant once; every
    # K6 call held against its plain version on its own tensors -----------
    kernels.reset_launches()
    per_call, answers, held = {}, [], HeldK6()
    for name in ["int8_chain"] * 3 + ["coattn_int8", "coattn_batch_refs"]:
        images, ids = request(8)
        before, passes = dict(kernels.LAUNCHES), held.quant_passes
        with held:
            out = run(name, images, ids)
        dec = decode_best(out.outbox, cfg)
        torch.cuda.synchronize()
        got = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        want = {"k6_convs": bb + trunk_k6_per_call(base.replace(**variants[name][0])),
                "coattn_attend": 12 if name == "int8_chain" else 0,
                "conv_s8_quant": held.quant_passes - passes}
        if launches_differ(got, want):
            raise AssertionError(f"int8 {name}: launches {got}, expected {want}")
        per_call.setdefault(name, []).append(got)
        for s_, ob in enumerate(out.outbox):
            g = cfg.grids[s_]
            if tuple(ob.shape) != (8, 3, 5, g, g) or not torch.isfinite(ob).all():
                raise AssertionError(f"int8 {name}: outbox[{s_}] bad {tuple(ob.shape)}")
        answers.append(dec.boxes[:, 0].cpu())
    launches = dict(kernels.LAUNCHES)
    held_on_path = held.summary("int8 eval", need=K6_PATH_ROUTES)

    # --- fp32 copies with the trunk PTQ on the card and the CPU, the same
    # qparams and scales (the int8 backbone's calls are among the held) ----
    images, ids = request(INT8_PARITY_CLIPS)
    cfg32 = base.replace(compute_dtype="float32", trunk_quant="int8")
    outs = {}
    for role, where in (("card", dev), ("cpu", torch.device("cpu"))):
        m = DCNet(cfg32, backbone_defs=defs, device=where)
        m.load_state_dict({k: v.to(where) for k, v in weights.items()})
        Q.set_trunk_scales(m, scales)
        q = qparams if role == "card" else _to_cpu(qparams)
        hooks = _capture_trunk_convs(m) if role == "card" else None
        t1 = time.perf_counter()
        outs[role] = Q.quant_eval_clip(m, q, images.to(where), ids.to(where),
                                       n_frame, int8_chain=True)
        seconds = time.perf_counter() - t1
        if hooks is not None:
            captured = hooks.close()
        else:
            stages = _trunk_convs_on_cpu(m, captured)
        del m
    parity = int8_parity(outs["card"], outs["cpu"], cfg32, INT8_PARITY_TOL)
    parity.update(cpu_s=seconds, trunk_convs_on_card_inputs=stages)
    kernels.reset_launches()

    # --- 64 clips: each int8 variant and the float bf16 eval_clip -----------
    float_model = DCNet(cfg, backbone_defs=defs, device=dev)
    float_model.load_state_dict(weights)
    images, ids = request(TIMING_CLIPS)
    timing = {}
    calls = {name: (lambda name=name: run(name, images, ids)) for name in variants}
    calls["float_bf16_eval_clip"] = lambda: float_model.eval_clip(images, ids, n_frame=n_frame)
    for name, fn in calls.items():
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(2):
            decode_best(fn().outbox, cfg)
        torch.cuda.synchronize()
        iters = 5
        t1 = time.perf_counter()
        for _ in range(iters):
            dec = decode_best(fn().outbox, cfg)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t1) / iters
        if not torch.isfinite(dec.boxes).all():
            raise AssertionError(f"int8 timing {name}: boxes not finite")
        timing[name] = {"clips": TIMING_CLIPS, "s_per_call": dt,
                        "clips_per_s": TIMING_CLIPS / dt,
                        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        if profile_dir:
            try:  # the profile or its error; one that stays lossy fails main
                timing[name]["profile"] = profile_call(fn, profile_dir, f"int8_{name}")
            except Exception as e:  # noqa: BLE001
                timing[name]["profile"] = {"error": repr(e)[:300]}
    kernels.reset_launches()
    rec = {"phase": "int8", "model": "YOLOv3/Darknet-53 + BiLSTM, 256 px, emb 512, "
           "hidden 512, corpus 1000, 5-frame clips, split corr_conv, bf16 activations, "
           "int8 backbone (68 live convs) + trunk PTQ (trunk_quant=int8)",
           "weights": "backbone: random_darknet_weights_file(seed=0); rest: "
                      "seeded_init_(seed=0)",
           "calibration": f"{INT8_CALIB_CLIPS * n_frame} uniform frames (seed 8): the "
                          f"backbone by quantize_model_backbone, the trunk by "
                          f"calibrate_trunk over a float eval_clip of them",
           "setup_s": setup_s, "calib_s": calib_s, "launches": launches,
           "launches_per_call": {k: v[0] for k, v in per_call.items()},
           "k6_held_on_path": held_on_path,
           "cpu_parity": {"clips": INT8_PARITY_CLIPS, "dtype": "float32",
                          "trunk": "int8", **parity},
           "timing": timing, "kind": torch.cuda.get_device_name(dev),
           "nvidia_smi": nvidia_smi()}
    emit(rec)
    del model, float_model
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
            "coattn_attend_bwd": 6 * TRAIN_STEPS, "coattn_ring": 0, "loc_gram": 0,
            "k6_convs": 0, "conv_s8_quant": 0}
    if launches_differ(launches, want):
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
            try:  # the profile or its error; one that stays lossy fails main
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


# --- the BERT language path -------------------------------------------------

BERT_MODEL = "bert-base-uncased"  # 768 hidden, 12 layers, 12 heads, 3072, 30522


def bert_config(**over):
    return full_width_config().replace(use_lstm=False, bert_model=BERT_MODEL, **over)


def bert_ids(word_ids: np.ndarray) -> np.ndarray:
    """`synthetic_clips`' corpus ids (..., L) as the fallback tokenizer's
    ids of the same phrases."""
    from dcnet_tpu_torch.data.bert_tokenize import encode_phrase, get_bert_tokenizer

    tok, inv = get_bert_tokenizer(BERT_MODEL), {i: w for w, i in WORDS.items()}
    flat = word_ids.reshape(-1, word_ids.shape[-1])
    out = np.stack([encode_phrase(tok, " ".join(inv[int(i)] for i in row if i),
                                  flat.shape[1])[0] for row in flat])
    return out.reshape(word_ids.shape).astype(np.int64)


def bert_phrase_ids(rng, n: int, query_len: int) -> np.ndarray:
    """n seeded phrases of the synthetic vocabulary, tokenized."""
    words = list(WORDS)
    ids = np.zeros((n, query_len), np.int64)
    for i in range(n):
        k = rng.randint(3, 12)
        ids[i, :k] = [WORDS[words[j]] for j in rng.randint(0, len(words), k)]
    return bert_ids(ids)


def phase_bert(dev, lstm_eval: dict, lstm_train: dict) -> dict:
    """The BERT path on the card at full width (see the module doc)."""
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.ops.decode import decode_best
    from dcnet_tpu_torch.train.loop import flatten_clip_batch, to_device, train_epoch
    from dcnet_tpu_torch.train.state import create_train_state
    from dcnet_tpu_torch.train.step import train_step

    cfg = bert_config()
    size, n_frame, k = cfg.image_size, 5, cfg.n_frames_train
    model, defs, setup_s = seeded_model(cfg, dev)
    rng = np.random.RandomState(2)

    def request(clips):
        images = rng.rand(clips * n_frame, size, size, 3).astype(np.float32)
        return (torch.from_numpy(images),
                torch.from_numpy(bert_phrase_ids(rng, clips, cfg.query_len)))

    # --- the eval path: requests of 8 clips, K1 12 a call --------------------
    kernels.reset_launches()
    for _ in range(3):
        images, ids = request(8)
        out = model.eval_clip(images.to(dev), ids.to(dev), n_frame=n_frame)
        dec = decode_best(out.outbox, cfg)
        if not all(torch.isfinite(ob).all() for ob in out.outbox) or \
                not torch.isfinite(dec.boxes).all():
            raise AssertionError("BERT eval_clip outputs not finite")
    torch.cuda.synchronize()
    eval_launches = dict(kernels.LAUNCHES)
    if launches_differ(eval_launches, {"coattn_attend": 36}):
        raise AssertionError(f"BERT eval_clip launches {eval_launches}, expected K1 12 "
                             f"a call (36)")

    # --- card against CPU in fp32 --------------------------------------------
    images, ids = request(2)
    cpu_model = DCNet(cfg, backbone_defs=defs, device="cpu")
    cpu_model.load_state_dict({n: v.cpu() for n, v in model.state_dict().items()})
    ref = cpu_model.eval_clip(images, ids, n_frame=n_frame)
    got = model.eval_clip(images.to(dev), ids.to(dev), n_frame=n_frame)
    parity_err = max((g.cpu() - r).abs().max().item() for g, r in zip(got.outbox, ref.outbox))
    for g, r in zip(got.outbox, ref.outbox):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-3, atol=1e-3)
    ref_dec, got_dec = decode_best(ref.outbox, cfg), decode_best(got.outbox, cfg)
    if not all(torch.equal(getattr(got_dec, f).cpu(), getattr(ref_dec, f))
               for f in ("best_n", "gi", "gj", "scale")):
        raise AssertionError("BERT decoded boxes differ between the card and CPU")
    del cpu_model

    # --- eval_clip at 64 clips, fp32 and bf16 ---------------------------------
    state = model.state_dict()
    timing = {}
    for dtype_name in ("float32", "bfloat16"):
        m = model if dtype_name == "float32" else DCNet(
            cfg.replace(compute_dtype=dtype_name), backbone_defs=defs, device=dev)
        if m is not model:
            m.load_state_dict(state)
        images, ids = (t.to(dev) for t in request(TIMING_CLIPS))
        for _ in range(2):
            decode_best(m.eval_clip(images, ids, n_frame=n_frame).outbox, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            dec = decode_best(m.eval_clip(images, ids, n_frame=n_frame).outbox, cfg)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t1) / 5
        timing[f"eval_{dtype_name}"] = {
            "clips": TIMING_CLIPS, "s_per_eval_clip": dt, "clips_per_s": TIMING_CLIPS / dt,
            "lstm_clips_per_s": lstm_eval[dtype_name]["clips_per_s"]}
        del m

    # --- train_epoch: K2 3 and K3 6 a step, the body bytewise unchanged ------
    state0 = {n: v.detach().clone() for n, v in model.state_dict().items()}

    def clips(n):
        b = synthetic_clips(rng, n, k, size, cfg.query_len)
        b["word_ids"] = bert_ids(b["word_ids"])
        return b

    st = create_train_state(model, cfg, steps_per_epoch=TRAIN_STEPS)
    kernels.reset_launches()
    averages = train_epoch(st, [clips(TRAIN_B) for _ in range(TRAIN_STEPS)], epoch=0,
                           print_freq=TRAIN_STEPS,
                           generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    train_launches = dict(kernels.LAUNCHES)
    want = {"coattn_pair": 3 * TRAIN_STEPS, "coattn_attend_bwd": 6 * TRAIN_STEPS}
    if launches_differ(train_launches, want):
        raise AssertionError(f"BERT train_epoch launches {train_launches}, expected {want}")
    if not all(np.isfinite(v) for v in averages.values()):
        raise AssertionError(f"BERT train metrics not finite: {averages}")
    after = model.state_dict()
    body = [n for n in after if n.startswith("textmodel.")
            and not n.startswith("textmodel.proj.")]
    changed = [n for n in body if not torch.equal(after[n], state0[n])]
    if len(body) != 5 + 16 * model.textmodel.cfg.num_layers or changed:
        raise AssertionError(f"the frozen BERT body moved: {changed[:5]} of {len(body)}")
    moved = {g: max((after[n] - state0[n]).abs().max().item() for n in after
                    if n.startswith(g) and after[n].is_floating_point())
             for g in ("textmodel.proj.", "visumodel.", "mapping_lang.", "fcn_emb.")}
    if min(moved.values()) <= 0:
        raise AssertionError(f"a trained part did not move: {moved}")
    del st

    # --- train_step at 16 clips, fp32 and bf16 --------------------------------
    for dtype_name in ("float32", "bfloat16"):
        m = DCNet(cfg.replace(compute_dtype=dtype_name), backbone_defs=defs, device=dev)
        m.load_state_dict(state0)
        s2 = create_train_state(m, cfg)
        batch = to_device(flatten_clip_batch(clips(TRAIN_B)), dev)
        for _ in range(WARMUP_STEPS):
            train_step(s2, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            metrics = train_step(s2, batch)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t1) / TIMED_STEPS
        if not all(torch.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"BERT {dtype_name} train metrics not finite")
        timing[f"train_{dtype_name}"] = {
            "clips": TRAIN_B, "s_per_step": dt, "frames_per_s": TRAIN_B * k / dt,
            "lstm_s_per_step": lstm_train[dtype_name]["s_per_step"]}
        del m, s2
    del model
    kernels.reset_launches()
    rec = {"phase": "bert", "model": f"YOLOv3/Darknet-53 + {BERT_MODEL} geometry (768 "
           "hidden, 12 layers, 12 heads, 3072, vocab 30522), 256 px, emb 512, frozen body",
           "weights": "backbone: random_darknet_weights_file(seed=0); rest, BERT "
                      "included: seeded_init_(seed=0)",
           "phrases": "fallback-tokenised phrases of the synthetic vocabulary, 20 tokens",
           "setup_s": setup_s, "eval_launches": eval_launches,
           "train_launches": train_launches,
           "cpu_parity": {"clips": 2, "max_abs_outbox_err": parity_err, "rtol": 1e-3,
                          "atol": 1e-3, "same_decoded_index": True},
           "frozen_body_tensors_unchanged": len(body), "moved_max_abs": moved,
           "train_averages": averages, "timing": timing,
           "kind": torch.cuda.get_device_name(dev), "nvidia_smi": nvidia_smi()}
    emit(rec)
    return rec


# --- the training CLI --------------------------------------------------------

TCLI_VIDEOS, TCLI_FRAMES, TCLI_BATCH, TCLI_STEPS = 4, 6, 4, 2
# 4 train videos of 6 frames at k=2: 16 clips, 4 batches of 4, 2 steps an
# epoch (--max_steps); the test split 2 videos of 6 frames: 8 clips, 2
# validate batches. Two epochs per run.
# A resumed run is held against the uninterrupted one at the distance
# between two uninterrupted runs (the largest element difference of any
# tensor, doubled): bitwise where the run repeats bitwise. RMSprop's first
# steps move each weight by ~lr * 10 * sign(g), so a rounding difference in
# a gradient near zero moves a weight by ~1e-3, which no relative limit on
# the weights would tell from a fault.
RESUME_SPREAD = 2.0


class _StepCounter:
    """Counts `train_step` and `eval_step` calls of `train.loop`, and
    profiles the card from the first `train_epoch` of cli.train when asked."""

    def __init__(self, profile: bool = False):
        from dcnet_tpu_torch.cli import train as cli_train
        from dcnet_tpu_torch.train import loop
        self.loop, self.cli, self.profile = loop, cli_train, profile
        self.calls = {"train_step": 0, "eval_step": 0}
        self.prof, self.t0 = None, None

    def __enter__(self):
        self.orig = {n: getattr(self.loop, n) for n in self.calls}
        self.orig_epoch = self.cli.train_epoch
        for name, fn in self.orig.items():
            def counted(*a, _fn=fn, _n=name, **k):
                self.calls[_n] += 1
                return _fn(*a, **k)
            setattr(self.loop, name, counted)

        def epoch(*a, **k):
            if self.profile and self.prof is None:
                from torch.profiler import ProfilerActivity, profile
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.start()
                self.t0 = time.perf_counter()
            return self.orig_epoch(*a, **k)
        self.cli.train_epoch = epoch
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.loop, name, fn)
        self.cli.train_epoch = self.orig_epoch

    def busy(self) -> tuple:
        """(seconds from the first epoch, card-busy seconds in them)."""
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        busy_us = sum(e.self_device_time_total for e in self.prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        return wall, busy_us / 1e6


def _train_cli(argv, profile: bool = False) -> tuple:
    """cli.train's `main` in-process: (state, stdout, seconds, step calls,
    launches, (wall, busy) or None)."""
    import contextlib
    import io
    from dcnet_tpu_torch.cli import train as cli_train

    kernels.reset_launches()
    out = io.StringIO()
    with _StepCounter(profile) as counter, contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        state = cli_train.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        busy = counter.busy() if profile else None
    return state, out.getvalue(), seconds, dict(counter.calls), dict(kernels.LAUNCHES), busy


def _epoch_lines(text: str) -> dict:
    accu = [tuple(map(float, m)) for m in re.findall(r"^accu (\S+) miou (\S+)$", text, re.M)]
    steps = [float(m) for m in re.findall(r"^Epoch \[\d+\]\[\d+\] .* batch_time (\S+) ", text, re.M)]
    return {"accu_miou": accu, "batch_time_s": steps}


def phase_train_cli(dev) -> dict:
    """cli.train in-process on the card at full width (see the module doc)."""
    import shutil
    import tempfile
    from dcnet_tpu_torch.cli import test as cli_test
    from dcnet_tpu_torch.data.synthetic import build_synthetic_corpus, generate_synthetic_vid
    from dcnet_tpu_torch.data.vid import VIDDataset
    from dcnet_tpu_torch.models.darknet import random_darknet_weights_file

    work = tempfile.mkdtemp(prefix="dcnet_train_cli_")
    cwd = os.getcwd()
    os.chdir(work)  # ./logs and ./saved_models
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        root = os.path.join(work, "synthetic")
        generate_synthetic_vid(root, "train", num_videos=TCLI_VIDEOS,
                               frames_per_video=TCLI_FRAMES, seed=13, frame_format="npy")
        generate_synthetic_vid(root, "test", num_videos=2, frames_per_video=TCLI_FRAMES,
                               seed=14, frame_format="npy")
        darknet = os.path.join(work, "backbone_seed0.weights")
        random_darknet_weights_file(_defs(), darknet, seed=0)
        size = int(CLI_WIDTH[CLI_WIDTH.index("--size") + 1])

        # the host data path with augmentation: every clip of the train split
        ds = VIDDataset(os.path.join(root, "VID_video_level_train.json"),
                        build_synthetic_corpus(), split="train", imsize=size,
                        num_frame_k=2, image_root=root, seed=13)
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        host_s = time.perf_counter() - t0
        host = {"clips": len(ds), "s": host_s, "ms_per_clip": 1e3 * host_s / len(ds),
                "augment": ds.augment}

        base = ["--synthetic"] + CLI_WIDTH + [
            "--batch_size", str(TCLI_BATCH), "--max_steps", str(TCLI_STEPS),
            "--workers", "4", "--seed", "13", "--split_root", work,
            "--backbone_weights", darknet, "--print_freq", "1"]
        encoders = {"lstm": ["--lstm"], "bert": ["--bert_model", BERT_MODEL]}
        runs, states = {}, {}
        for enc, flags in encoders.items():
            state, text, s, calls, launches, busy = _train_cli(
                base + flags + ["--nb_epoch", "2", "--savename", f"{enc}_full"],
                profile=enc == "lstm")
            want = {"coattn_pair": 3 * (calls["train_step"] + calls["eval_step"]),
                    "coattn_attend_bwd": 6 * calls["train_step"]}
            if calls["train_step"] != 2 * TCLI_STEPS or launches_differ(launches, want):
                raise AssertionError(f"cli.train {enc}: {calls} steps, launches {launches}, "
                                     f"expected {want}")
            lines = _epoch_lines(text)
            files = sorted(os.listdir(os.path.join("saved_models", f"{enc}_full")))
            if len(lines["accu_miou"]) != 2 or files != ["0.pth.tar", "1.pth.tar"] or \
                    not all(0 <= v <= 1 for am in lines["accu_miou"] for v in am):
                raise AssertionError(f"cli.train {enc}: {lines}, checkpoints {files}")
            states[enc] = {n: v.detach().cpu().clone()
                           for n, v in state.model.state_dict().items()}
            runs[enc] = {"wall_s": s, "steps": calls, "launches": launches,
                         "launches_per_train_step": {"coattn_pair": 3, "coattn_attend_bwd": 6},
                         "launches_per_eval_step": {"coattn_pair": 3},
                         "s_per_step_epoch1": float(np.mean(lines["batch_time_s"][TCLI_STEPS:])),
                         **lines, "checkpoints": files}
            if busy:
                runs[enc]["epochs_s"], runs[enc]["device_busy_s"] = busy
                runs[enc]["device_busy_share"] = busy[1] / busy[0]
            del state

        # --- resume after epoch 0 against the uninterrupted run (LSTM); a
        # second uninterrupted run gives the card's run-to-run spread. These
        # four runs take torch's deterministic algorithms (the profiled run
        # above does not, and differs from them) ------------------------------
        lstm = base + encoders["lstm"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                ends = [_train_cli(lstm + ["--nb_epoch", "2", "--savename", f"run{i}"])[0]
                        for i in range(2)]
                _train_cli(lstm + ["--nb_epoch", "1", "--savename", "resume"])
                state, text, _, calls, _, _ = _train_cli(
                    lstm + ["--nb_epoch", "2", "--savename", "resume",
                            "--resume", "saved_models/resume"])
            finally:
                torch.use_deterministic_algorithms(False)
        if calls["train_step"] != TCLI_STEPS or "resumed from" not in text:
            raise AssertionError(f"the resumed run took {calls}: {text[-500:]}")
        def weights(st):
            return {n: v.detach().cpu() for n, v in st.model.state_dict().items()}

        full = weights(ends[0])

        def spread(other):
            d = {n: (other[n].double() - full[n].double()).abs().max().item()
                 for n in full if full[n].is_floating_point()}
            worst = max(d, key=d.get)
            return d[worst], worst, sum(v > 0 for v in d.values())

        repeat_d, repeat_at, repeat_n = spread(weights(ends[1]))
        resume_d, resume_at, resume_n = spread(weights(state))
        profiled_d = spread(states["lstm"])[0]
        if resume_d > RESUME_SPREAD * repeat_d:
            raise AssertionError(f"the resumed run differs from the uninterrupted one by "
                                 f"{resume_d} at {resume_at}; a repeated run by "
                                 f"{repeat_d} at {repeat_at}")
        resume = {"bitwise": resume_d == 0.0, "max_abs_diff": resume_d, "at": resume_at,
                  "tensors_differing": resume_n, "repeat_bitwise": repeat_d == 0.0,
                  "repeat_max_abs_diff": repeat_d, "repeat_at": repeat_at,
                  "repeat_tensors_differing": repeat_n, "limit": f"{RESUME_SPREAD} x repeat",
                  "profiled_run_max_abs_diff": profiled_d,
                  "cudnn_deterministic": True, "deterministic_algorithms": "warn_only",
                  "nondeterministic_ops": sorted({str(w.message)[:160] for w in caught
                                                  if "deterministic" in str(w.message)})}
        del state, ends

        # --- cli.test --resume <the checkpoint dir>, card against CPU ---------
        tests = {}
        for enc, flags in encoders.items():
            argv = ["--synthetic"] + CLI_WIDTH + flags + [
                "--num_frame_k", str(CLI_K), "--batch_size", "4", "--seed", "13",
                "--split_root", work, "--workers", "4", "--savename", f"t_{enc}",
                "--resume", os.path.join("saved_models", f"{enc}_full")]
            kernels.reset_launches()
            card, s = _cli_output(cli_test.main, argv)
            k1 = kernels.LAUNCHES["coattn_attend"]
            cpu, cpu_s = _cli_output(cli_test.main, argv, platform="cpu")
            tests[enc] = {"card": cli_metrics(card), "cpu": cli_metrics(cpu),
                          "card_s": s, "cpu_s": cpu_s, "k1_launches": k1,
                          **_close(cli_metrics(card), cli_metrics(cpu),
                                   f"cli.test {enc} card against CPU")}
            if not k1:
                raise AssertionError(f"cli.test {enc} launched no K1")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    kernels.reset_launches()
    launches = {n: sum(r["launches"][n] for r in runs.values())
                for n in ("coattn_pair", "coattn_attend_bwd")}
    rec = {"phase": "train_cli", "runs": runs, "resume": resume, "test": tests,
           "host_data_path": host, "launches": launches,
           "split": f"synthetic .npy frames, seed 13: train {TCLI_VIDEOS} videos x "
                    f"{TCLI_FRAMES} frames (augmented), test 2 x {TCLI_FRAMES} (seed 14)",
           "argv": base, "kind": torch.cuda.get_device_name(dev), "nvidia_smi": nvidia_smi()}
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


def launches_differ(got: dict, want: dict) -> bool:
    """Whether a run's launches (`got`: LAUNCHES, or the difference of two
    of its copies) differ from `want`: each kernel's count as `want` gives
    it (0 where it gives none), K6's convolutions on all routes together
    against `want["k6_convs"]` (the route of each call is its plan's,
    which `HeldK6` holds)."""
    routes = kernels.CONV_S8_KEYS.values()
    return kernels.conv_s8_launches(got) != want.get("k6_convs", 0) or any(
        got[k] != want.get(k, 0) for k in got if k not in routes)


def _expect_launches(per_tick, want: dict, what: str) -> None:
    for t, got in enumerate(per_tick):
        if launches_differ(got, want):
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
            try:  # the profile or its error; one that stays lossy fails main
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


class DecodeTaps:
    """Inside the `with`, records each `decode_best` call of the serving
    engine: per stream the whole raw output `outbox` (every scale's (3, 5,
    g, g) flattened), the argmax cell `idx`, the top two conf values
    `top2`, the cell's `scale`, its `box` and `score` (on the CPU)."""

    def __enter__(self):
        from dcnet_tpu_torch.serving import engine
        self._mod, self._real, self.taps = engine, engine.decode_best, []
        engine.decode_best = self._call
        return self

    def __exit__(self, *exc) -> bool:
        self._mod.decode_best = self._real
        return False

    def _call(self, outbox, cfg):
        from dcnet_tpu_torch.ops.decode import flatten_conf
        dec = self._real(outbox, cfg)
        conf = flatten_conf(outbox).float()
        self.taps.append({"outbox": torch.cat([o.reshape(o.shape[0], -1).float()
                                               for o in outbox], dim=1).cpu(),
                          "idx": torch.argmax(conf, dim=1).cpu(),
                          "top2": torch.topk(conf, 2, dim=1).values.cpu(),
                          "scale": dec.scale[:, 0].cpu(), "box": dec.boxes[:, 0].cpu(),
                          "score": dec.score[:, 0].cpu()})
        return dec


def serve_cells_held(card: list, cpu: list, strides, score_tol: float,
                     box_atol: float) -> dict:
    """The raw predictions of the card and the CPU, tick by tick (`DecodeTaps`
    records): every raw output (conf and box logits of every cell) within
    score_tol, as the int8 eval holds its outbox; each stream's score
    within score_tol; its decoded cell equal
    wherever the CPU's top two conf values differ by more than score_tol
    (a near tie, where the cell may move: exempt and counted); where the
    cells agree, the box within what score_tol on the raw outputs allows,
    score_tol (stride / 4 + 0.51 max(w, h)) + box_atol px per coordinate
    (the centre moves by at most a quarter of the logit's change times the
    stride, each edge by half the size's change, exp(score_tol) - 1 < 1.02
    score_tol of the size)."""
    stats = {"stream_ticks": 0, "cells_equal": 0, "near_ties": 0, "cells_moved": 0,
             "max_outbox_err": 0.0, "max_score_err": 0.0, "max_box_err": 0.0,
             "max_box_share_of_limit": 0.0, "score_tol": score_tol, "box_atol": box_atol}
    bad = []
    for t, (g, w) in enumerate(zip(card, cpu)):
        out_err = (g["outbox"] - w["outbox"]).abs().amax(dim=1)
        stats["max_outbox_err"] = max(stats["max_outbox_err"], float(out_err.max()))
        for i in torch.nonzero(out_err > score_tol).flatten().tolist():
            bad.append(f"tick {t} stream {i}: raw outputs {out_err[i]:.3g} apart")
        score_err = (g["score"] - w["score"]).abs()
        tie = (w["top2"][:, 0] - w["top2"][:, 1]) <= score_tol
        same = g["idx"] == w["idx"]
        stride = torch.tensor([float(strides[int(s_)]) for s_ in w["scale"]])
        size = (w["box"][:, 2:] - w["box"][:, :2]).abs().amax(dim=1)
        limit = score_tol * (stride / 4 + 0.51 * size) + box_atol
        box_err = (g["box"] - w["box"]).abs().amax(dim=1)
        for i in range(len(score_err)):
            if score_err[i] > score_tol:
                bad.append(f"tick {t} stream {i}: scores {score_err[i]:.3g} apart")
            if not same[i] and not tie[i]:
                bad.append(f"tick {t} stream {i}: another cell, the CPU's top two "
                           f"{float(w['top2'][i, 0] - w['top2'][i, 1]):.3g} apart")
            if same[i] and box_err[i] > limit[i]:
                bad.append(f"tick {t} stream {i}: boxes {box_err[i]:.3g} px apart "
                           f"(limit {limit[i]:.3g})")
        stats["stream_ticks"] += len(score_err)
        stats["cells_equal"] += int(same.sum())
        stats["near_ties"] += int(tie.sum())
        stats["cells_moved"] += int((~same).sum())
        stats["max_score_err"] = max(stats["max_score_err"], float(score_err.max()))
        if same.any():
            stats["max_box_err"] = max(stats["max_box_err"], float(box_err[same].max()))
            stats["max_box_share_of_limit"] = max(stats["max_box_share_of_limit"],
                                                  float((box_err / limit)[same].max()))
    if not card or len(card) != len(cpu):
        bad.append(f"{len(card)} card ticks against {len(cpu)} CPU ticks")
    return {"ok": not bad, "failures": bad[:10], **stats}


def phase_serving_int8(dev, profile_dir=None) -> dict:
    """The quantized serving tick: the serving phase's model and streams,
    `GroundingEngine.quantize()` on 16 of the streams' frames and one
    phrase (the JAX serving bench's calibration; int8 backbone and trunk,
    no int8 chain), then 12 ticks at 120 streams in each mode (multiref
    with int8 rings, multiref with float rings, the K1 path), launches per
    tick checked (K6: the live backbone convs + the no-split trunk's),
    every K6 call of each mode's last tick held against its plain version
    (`HeldK6`), each mode timed as the serving phase times its ticks; 4
    fp32 streams on the card against the same quantized engine on the CPU
    per tick: with the int8 backbone alone boxes and scores within
    SERVE_TOL; with the trunk PTQ too the raw predictions by
    `serve_cells_held` and the trunk convs bitwise on the card's own
    inputs."""
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.ops import quant as Q
    from dcnet_tpu_torch.serving.engine import GroundingEngine, cast_params_for_serving

    cfg = serving_config(compute_dtype="bfloat16", coattn_multiref=True)
    size, n = cfg.image_size, SERVE_STREAMS
    model, defs, setup_s = seeded_model(cfg, dev)
    cast_params_for_serving(model)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(3)
    ids = _phrases(rng, cfg, n).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)

    def frames_at(_t):
        return torch.rand((n, size, size, 3), generator=gen, device=dev)

    t0 = time.perf_counter()
    calib = frames_at(0)[:16]
    ring_eng = GroundingEngine(model, n, int8_rings=True).quantize(calib, ids[:1])
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    k1_model = DCNet(cfg.replace(coattn_multiref=False, trunk_quant="int8"),
                     backbone_defs=defs, device=dev)
    k1_model.load_state_dict(weights)
    Q.set_trunk_scales(k1_model, ring_eng.trunk_scales)
    engines = {"multiref_int8_rings": ring_eng,
               "multiref": GroundingEngine(model, n),
               "k1": GroundingEngine(k1_model, n)}
    for name in ("multiref", "k1"):
        engines[name].qparams = ring_eng.qparams
    k6 = backbone_k6_per_call() + trunk_k6_per_call(model.cfg)
    want = {"multiref_int8_rings": {"k6_convs": k6, "coattn_ring": 3},
            "multiref": {"k6_convs": k6, "coattn_ring": 3},
            "k1": {"k6_convs": k6, "coattn_attend": 12}}
    launches, timing, held_on_path = {}, {}, {}
    for name, eng in engines.items():
        kernels.reset_launches()
        held, marks = HeldK6(), []

        def frames_held(t):  # hold the K6 calls of the last tick
            held.active = t == SERVE_TICKS - 1
            marks.append(held.quant_passes)
            return frames_at(t)

        with held:
            state, per_tick, outs = _serve(eng, ids, SERVE_TICKS, frames_held)
        held_on_path[name] = held.summary(f"quantized serving, {name}", need=K6_PATH_ROUTES)
        # each tick's quantize passes as its plans asked for them (a padded
        # weight is kept from its first tick on); the last tick's recorded
        marks.append(held.quant_passes)
        for t, got in enumerate(per_tick):
            want[name]["conv_s8_quant"] = marks[t + 1] - marks[t]
            _expect_launches([got], want[name], f"quantized serving, {name}, tick {t}")
        _finite(outs, f"quantized serving, {name}")
        launches[name] = dict(kernels.LAUNCHES)
        frames = frames_at(0)
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
            try:  # the profile or its error; one that stays lossy fails main
                timing[name]["profile"] = profile_call(
                    lambda: eng.step(state, frames), profile_dir,
                    f"serving_tick_{name}_int8_bf16")
            except Exception as e:  # noqa: BLE001
                timing[name]["profile"] = {"error": repr(e)[:300]}
        del state
    kernels.reset_launches()

    # --- 4 fp32 streams: the quantized engine on the card and on the CPU -----
    # the int8 backbone alone (trunk=False): bitwise on both sides, the rest
    # float, so boxes and scores within SERVE_TOL; with the trunk PTQ the raw
    # predictions by `serve_cells_held` (code flips, see INT8_PARITY_TOL) and
    # each trunk conv of the card's last tick bitwise equal to the CPU's on
    # its inputs
    cfg32 = serving_config(compute_dtype="float32", coattn_multiref=True)
    prng = np.random.RandomState(4)
    pframes = prng.rand(INT8_PARITY_TICKS, PARITY_STREAMS, size, size, 3).astype(np.float32)
    pids = _phrases(prng, cfg32, PARITY_STREAMS)
    parity = {}
    for trunk in (False, True):
        card_model = DCNet(cfg32, backbone_defs=defs, device=dev)
        card_model.load_state_dict(weights)
        card = GroundingEngine(card_model, PARITY_STREAMS, int8_rings=True).quantize(
            torch.from_numpy(pframes[:4].reshape(-1, size, size, 3)).to(dev), pids[:1],
            trunk=trunk)
        cpu_model = DCNet(card_model.cfg, backbone_defs=defs, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in card_model.state_dict().items()})
        if trunk:
            Q.set_trunk_scales(cpu_model, card.trunk_scales)
        cpu = GroundingEngine(cpu_model, PARITY_STREAMS, int8_rings=True)
        cpu.qparams = _to_cpu(card.qparams)
        states = {"card": card.init_state(pids), "cpu": cpu.init_state(pids)}
        worst, taps, t1 = 0.0, {"card": [], "cpu": []}, time.perf_counter()
        for t in range(INT8_PARITY_TICKS):
            hooks = (_capture_trunk_convs(card_model) if trunk and t == INT8_PARITY_TICKS - 1
                     else None)
            got = {}
            for role, eng in (("card", card), ("cpu", cpu)):
                with DecodeTaps() as tap:
                    states[role], *o = eng.step(states[role], torch.from_numpy(pframes[t]))
                taps[role] += tap.taps
                got[role] = [x.cpu() for x in o]
            if hooks is not None:
                stages = _trunk_convs_on_cpu(cpu_model, hooks.close())
            if not trunk:
                for a, b in zip(got["card"], got["cpu"]):
                    torch.testing.assert_close(a, b, **SERVE_TOL)
                    worst = max(worst, (a - b).abs().max().item())
        key = "int8_backbone_and_trunk" if trunk else "int8_backbone"
        if trunk:
            parity[key] = serve_cells_held(taps["card"], taps["cpu"], cfg32.strides,
                                           INT8_PARITY_TOL["atol"], SERVE_TOL["atol"])
            if not parity[key]["ok"]:
                raise AssertionError(f"quantized serving with the trunk PTQ, card against "
                                     f"CPU: {parity[key]}")
            parity[key].update(trunk_convs_on_card_inputs=stages,
                               not_held="the fused boxes (the top-k cache window)")
        else:
            parity[key] = {"max_abs_err": worst, "tol": SERVE_TOL,
                           "held": "fused and raw boxes and scores"}
        parity[key]["seconds"] = time.perf_counter() - t1
        del card, cpu, card_model, cpu_model, states
    parity.update(streams=PARITY_STREAMS, ticks=INT8_PARITY_TICKS, mode="multiref_int8_rings")
    kernels.reset_launches()
    rec = {"phase": "serving_int8", "model": "the serving phase's, quantize()d: int8 "
           "backbone (68 live convs) and trunk, no int8 chain, bf16",
           "setup_s": setup_s, "quantize_s": quantize_s, "streams": n,
           "ticks": SERVE_TICKS, "launches": launches,
           "launches_per_tick": want, "k6_held_on_path": held_on_path,
           "cpu_parity": parity, "timing": timing,
           "kind": torch.cuda.get_device_name(dev), "nvidia_smi": nvidia_smi()}
    emit(rec)
    return rec


PROFILE_FAILURES = []   # the profiles that failed (`main` fails on any)


def profile_call(fn, out_dir, tag) -> dict:
    """`utils.profiling.profile_call`: one call of fn traced, its device
    time by kernel and busy share, and every hand-written kernel's launches
    by name (K1-K6, `profiling.KERNEL_GROUPS`) held against
    `kernels.LAUNCHES`; a call whose every trace lost kernels is listed in
    PROFILE_FAILURES and raises."""
    try:
        return profiling.profile_call(fn, out_dir, tag)
    except profiling.LostTrace:
        PROFILE_FAILURES.append(tag)
        raise


# --- phase 7: the eval CLIs ---------------------------------------------------

CLI_VIDEOS, CLI_FRAMES = 4, 9     # 4 windows a video at k=5: 16 windows
CLI_K = 5
CLI_WIDTH = ["--size", "256", "--emb_size", "512", "--lstm_hidden", "512"]
LOCK_ROWS = 10                    # the rows the JAX package's lock tests use
CLI_ACC_TOL, CLI_MIOU_TOL = 1e-6, 2e-3   # tests/test_cli.py's limits
INT8_ACC_TOL, INT8_MIOU_TOL = 0.11, 0.03 # int8 against float, tests/test_cli.py:84-107
CACHE_TOL = dict(rtol=1e-4, atol=1e-5)   # cache scores, card against CPU
CACHE_BOX_ATOL = 1e-3                    # cache boxes, px


def _cli_output(main, argv, rows=None, platform=None, use_native=None) -> tuple:
    """Run a CLI `main` in-process: (stdout text, wall seconds). `rows`
    keeps the first rows of the split (the JAX package's lock tests patch
    `build_dataset` the same way); `platform` sets DCNET_PLATFORM;
    `use_native` sets the datasets' (True: the C++ host loader required)."""
    import contextlib
    import io
    from dcnet_tpu_torch.cli import common, eval_single, test as cli_test

    build = common.build_dataset

    def limited(*a, **k):
        ds, corpus = build(*a, **k)
        ds.chunks = ds.chunks[:rows]
        if use_native is not None:
            ds.use_native = use_native
        return ds, corpus

    saved_env = os.environ.get("DCNET_PLATFORM")
    mods = (common, cli_test, eval_single)
    try:
        if rows is not None or use_native is not None:
            for m in mods:
                m.build_dataset = limited
        if platform is not None:
            os.environ["DCNET_PLATFORM"] = platform
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            main(argv)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return out.getvalue(), time.perf_counter() - t0
    finally:
        for m in mods:
            m.build_dataset = build
        if saved_env is None:
            os.environ.pop("DCNET_PLATFORM", None)
        else:
            os.environ["DCNET_PLATFORM"] = saved_env


def cli_metrics(text: str, prefix: str = "") -> tuple:
    """(acc, miou) of a CLI's `acc,miou` line, or of its `post_process:`
    line with prefix='post_process:'."""
    for line in text.strip().splitlines():
        if line.startswith(prefix) and ("post_process" in line) == bool(prefix):
            acc, miou = line[len(prefix):].strip().split(",")
            return float(acc), float(miou)
    raise AssertionError(f"no {prefix or 'acc,miou'} line in {text!r}")


def _close(a: tuple, b: tuple, what: str) -> dict:
    ok = abs(a[0] - b[0]) <= CLI_ACC_TOL and abs(a[1] - b[1]) <= CLI_MIOU_TOL
    if not ok:
        raise AssertionError(f"{what}: {a} against {b} (acc {CLI_ACC_TOL}, "
                             f"miou {CLI_MIOU_TOL})")
    return {"got": a, "want": b, "acc_tol": CLI_ACC_TOL, "miou_tol": CLI_MIOU_TOL}


class _K1PerCall:
    """K1 launches per `eval_clip` and per `eval_features` call, counted by
    wrapping the two methods of the class for the duration of the phase
    (`eval_clip` calls `eval_features`: each call counts its own)."""

    def __init__(self):
        from dcnet_tpu_torch.models.dcnet import DCNet
        self.cls = DCNet
        self.orig = {n: getattr(DCNet, n) for n in ("eval_clip", "eval_features")}
        self.calls = {n: [] for n in self.orig}

    def __enter__(self):
        for name, fn in self.orig.items():
            def wrapped(model, *a, _fn=fn, _name=name, **k):
                before = kernels.LAUNCHES["coattn_attend"]
                out = _fn(model, *a, **k)
                self.calls[_name].append(kernels.LAUNCHES["coattn_attend"] - before)
                return out
            setattr(self.cls, name, functools.wraps(fn)(wrapped))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.cls, name, fn)

    def take(self) -> dict:
        out = {n: list(v) for n, v in self.calls.items()}
        for v in self.calls.values():
            v.clear()
        return out


def _expect_per_call(calls: dict, method: str, what: str) -> None:
    per = calls[method]
    if not per or any(n != 12 for n in per):
        raise AssertionError(f"{what}: K1 launches per {method} call {per}, "
                             f"expected 12 each (4 references x 3 scales)")


def _tie_runs(scores: np.ndarray) -> list:
    """A row's ranks grouped into runs of ties: neighbours whose scores lie
    within the sum of their score limits (CACHE_TOL), so either side may
    rank them the other way round."""
    lim = CACHE_TOL["atol"] + CACHE_TOL["rtol"] * np.abs(scores)
    runs, start = [], 0
    for i in range(1, len(scores) + 1):
        if i == len(scores) or scores[i - 1] - scores[i] > lim[i - 1] + lim[i]:
            runs.append(range(start, i))
            start = i
    return runs


def cache_agreement(got, want) -> dict:
    """A temporal cache (the arrays of `cache.npz`) held against a
    reference run's: every score within CACHE_TOL of the reference's at the
    same rank, every box within CACHE_BOX_ATOL px of the reference's at the
    same rank, the ground truth, geometry and video ids equal. Only
    candidates whose reference scores tie within the score limits may trade
    ranks: inside such a run each box must match a distinct reference box
    of the run. A row's last run (the one that holds the k-th rank) may
    hold one box that matches none: one candidate the reference ranked just
    below k, tied with its k-th (its score still within the limit), which
    pushed one of the reference's tied boxes out of the top k. Ranks inside
    a tie are interchangeable, so that box may stand at any rank of the
    run."""
    gs, ws = np.asarray(got["scores"]), np.asarray(want["scores"])
    gb, wb = np.asarray(got["boxes"]), np.asarray(want["boxes"])
    lim = CACHE_TOL["atol"] + CACHE_TOL["rtol"] * np.abs(ws)
    scores_ok = gs.shape == ws.shape and bool(np.all(np.abs(gs - ws) <= lim))
    traded, bad_rows = [], []
    if gb.shape == wb.shape and scores_ok:
        for r in range(ws.shape[0]):
            for run in _tie_runs(ws[r]):
                idx = list(run)
                free = list(idx)
                unseen = 1 if idx[-1] == ws.shape[1] - 1 else 0
                for i in idx:
                    hit = [j for j in free if np.abs(gb[r, i] - wb[r, j]).max() <= CACHE_BOX_ATOL]
                    if hit:
                        free.remove(hit[0])
                        if hit[0] != i:
                            traded.append({"row": r, "rank": i, "reference_rank": hit[0],
                                           "scores": ws[r, idx].tolist()})
                    elif unseen:
                        unseen -= 1
                        traded.append({"row": r, "rank": i, "reference_rank": None,
                                       "scores": ws[r, idx].tolist()})
                    else:
                        bad_rows.append({"row": r, "rank": i, "got_box": gb[r, i].tolist(),
                                         "want_box": wb[r, i].tolist(),
                                         "got_scores": gs[r].tolist(),
                                         "want_scores": ws[r].tolist()})
    same = {k: bool(np.array_equal(got[k], want[k]))
            for k in ("gt_boxes", "ratios", "dws", "dhs", "video_ids")}
    box_err = float(np.abs(gb - wb).max()) if gb.shape == wb.shape else None
    ok = scores_ok and gb.shape == wb.shape and not bad_rows and all(same.values())
    return {"ok": ok, "rows": int(ws.shape[0]), "topk": int(ws.shape[1]),
            "max_abs_score_err": float(np.abs(gs - ws).max()) if scores_ok else None,
            "scores_ok": scores_ok, "max_abs_box_err_px_same_rank": box_err,
            "ranks_traded_in_ties": traded, "mismatched": bad_rows[:4],
            "geometry_equal": same, **CACHE_TOL, "box_atol_px": CACHE_BOX_ATOL}


def _cache_held(card_npz: str, cpu_npz: str) -> dict:
    """The card's fp32 cache.npz against the CPU run's (`cache_agreement`)."""
    got, want = np.load(card_npz, allow_pickle=True), np.load(cpu_npz, allow_pickle=True)
    if set(got.files) != set(want.files):
        raise AssertionError(f"cache keys {got.files} against {want.files}")
    rec = cache_agreement(got, want)
    if not rec["ok"]:
        raise AssertionError(f"the card's cache differs from the CPU's: {rec}")
    return rec


def phase_cli(dev) -> dict:
    """The port's eval CLIs in-process on the card (see the module doc)."""
    import shutil
    import tempfile
    from dcnet_tpu_torch.cli import eval_single, post_process, test as cli_test
    from dcnet_tpu_torch.data.synthetic import generate_synthetic_vid
    from dcnet_tpu_torch.data.vid import VIDDataset
    from dcnet_tpu_torch.data.synthetic import build_synthetic_corpus
    from dcnet_tpu_torch.models.darknet import random_darknet_weights_file

    work = tempfile.mkdtemp(prefix="dcnet_cli_")
    cwd = os.getcwd()
    os.chdir(work)  # setup_logging writes ./logs
    try:
        full_root = os.path.join(work, "full")
        generate_synthetic_vid(os.path.join(full_root, "synthetic"), "test",
                               num_videos=CLI_VIDEOS, frames_per_video=CLI_FRAMES,
                               seed=13, frame_format="npy")
        lock_root = os.path.join(work, "lock")
        generate_synthetic_vid(os.path.join(lock_root, "synthetic"), "test",
                               num_videos=32, frames_per_video=8, seed=13,
                               frame_format="npy")
        darknet = os.path.join(work, "backbone_seed0.weights")
        random_darknet_weights_file(_defs(), darknet, seed=0)
        frames_before = sorted(os.listdir(os.path.join(full_root, "synthetic", "frames")))

        # the host data path alone: one pass over the split, no model
        ds = VIDDataset(os.path.join(full_root, "synthetic", "VID_video_level_test.json"),
                        build_synthetic_corpus(), split="test",
                        imsize=int(CLI_WIDTH[CLI_WIDTH.index("--size") + 1]),
                        num_frame_k=CLI_K, testmode=True,
                        image_root=os.path.join(full_root, "synthetic"))
        windows = len(ds)
        t0 = time.perf_counter()
        for i in range(windows):
            ds[i]
        host_data_s = time.perf_counter() - t0

        full = ["--synthetic", "--lstm"] + CLI_WIDTH + ["--num_frame_k", str(CLI_K),
                "--batch_size", "8", "--seed", "13", "--split_root", full_root,
                "--backbone_weights", darknet, "--savename", "cli"]
        # the model's set-up alone (seeded weights, the Darknet file spliced)
        from dcnet_tpu_torch.cli import common as cli_common
        args = cli_test.parser().parse_args(full)
        t0 = time.perf_counter()
        cli_common.splice_backbone_weights(args, cli_common.build_model(
            args, cli_common.config_from_args(args, len(build_synthetic_corpus())), dev))
        torch.cuda.synchronize()
        model_setup_s = time.perf_counter() - t0

        runs, checks = {}, {}
        kernels.reset_launches()
        with _K1PerCall() as k1:
            for dt in ("fp32", "bf16"):
                dtf = ["--bf16"] if dt == "bf16" else []
                cache = ["--cache_dir", os.path.join(work, "cache", dt)]
                text, s = _cli_output(cli_test.main, full + dtf + cache + [
                    "--cache", "--post_process"])
                calls = k1.take()
                _expect_per_call(calls, "eval_clip", f"{dt} standard eval")
                runs[f"{dt}_standard"] = {"output": text.strip().splitlines(),
                                          "wall_s": s, "clips_per_s": windows / s,
                                          "k1_per_eval_clip": calls["eval_clip"]}
                text_s, s = _cli_output(cli_test.main, full + dtf + [
                    "--stream_eval", "--post_process"])
                calls = k1.take()
                if calls["eval_clip"]:
                    raise AssertionError("--stream_eval called eval_clip")
                _expect_per_call(calls, "eval_features", f"{dt} stream eval")
                runs[f"{dt}_stream"] = {"output": text_s.strip().splitlines(),
                                        "wall_s": s, "clips_per_s": windows / s,
                                        "k1_per_eval_features": calls["eval_features"]}
                checks[f"{dt}_stream_equals_standard"] = _close(
                    cli_metrics(text_s), cli_metrics(text), f"{dt} stream against standard")
                for out in (text, text_s):
                    if not all(np.isfinite(cli_metrics(out))):
                        raise AssertionError(f"{dt}: metrics not finite: {out!r}")
            launches = dict(kernels.LAUNCHES)
        if launches["coattn_attend"] == 0:
            raise AssertionError(f"the CLI path never launched K1: {launches}")

        # post_process.py on the fp32 cache prints what --post_process did
        fp32_cache = ["--cache_dir", os.path.join(work, "cache", "fp32"),
                      "--savename", "cli", "--num_frame_k", str(CLI_K), "--size", "256"]
        text_pp, _ = _cli_output(post_process.main, fp32_cache)
        checks["post_process_cli_equals_test_cli"] = _close(
            cli_metrics(text_pp), cli_metrics("\n".join(runs["fp32_standard"]["output"]),
                                              "post_process:"), "post_process.py")

        # the CPU reference run of the fp32 cache (TF32 is off on the card)
        cpu_dir = os.path.join(work, "cache", "cpu")
        text_cpu, cpu_s = _cli_output(cli_test.main, full + [
            "--cache_dir", cpu_dir, "--cache", "--workers", "0"], platform="cpu")
        checks["fp32_cache_card_equals_cpu"] = _cache_held(
            os.path.join(work, "cache", "fp32", "cli", "cache.npz"),
            os.path.join(cpu_dir, "cli", "cache.npz"))
        checks["fp32_cache_card_equals_cpu"]["cpu_s"] = cpu_s
        checks["fp32_metrics_card_equals_cpu"] = _close(
            cli_metrics("\n".join(runs["fp32_standard"]["output"])),
            cli_metrics(text_cpu), "fp32 standard eval, card against CPU")

        # eval_single (DCNet.single_image: no kernel) on the card and the CPU
        single = full + ["--workers", "0"]
        text_1, s = _cli_output(eval_single.main, single)
        runs["single_fp32"] = {"output": text_1.strip().splitlines(), "wall_s": s}
        text_1c, _ = _cli_output(eval_single.main, single, platform="cpu")
        checks["eval_single_card_equals_cpu"] = _close(
            cli_metrics(text_1), cli_metrics(text_1c), "eval_single, card against CPU")
        if sorted(os.listdir(os.path.join(full_root, "synthetic", "frames"))) != frames_before:
            raise AssertionError("a CLI wrote frames into the split it read")

        # trained weights: the committed tiny lock, 10 rows, card and CPU
        lock = ["--synthetic", "--lstm", "--mini", "--size", "64", "--emb_size", "256",
                "--lstm_hidden", "256", "--num_frame_k", str(CLI_K), "--batch_size", "4",
                "--seed", "13", "--split_root", lock_root, "--workers", "0",
                "--resume", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                         "tests", "locks", "converge32tiny.npz"),
                "--savename", "lock"]
        text_l, s = _cli_output(cli_test.main, lock, rows=LOCK_ROWS)
        text_ls, _ = _cli_output(cli_test.main, lock + ["--stream_eval"], rows=LOCK_ROWS)
        text_lc, _ = _cli_output(cli_test.main, lock, rows=LOCK_ROWS, platform="cpu")
        lock_card, lock_cpu = cli_metrics(text_l), cli_metrics(text_lc)
        checks["lock_card_equals_cpu"] = _close(lock_card, lock_cpu, "lock, card against CPU")
        checks["lock_stream_equals_standard"] = _close(
            cli_metrics(text_ls), lock_card, "lock, stream against standard")
        if not lock_card[1] > 0.05:
            raise AssertionError(f"the lock grounds nothing on the card: {lock_card}")
        runs["lock_fp32"] = {"rows": LOCK_ROWS, "output": text_l.strip().splitlines(),
                             "stream_output": text_ls.strip().splitlines(),
                             "cpu_output": text_lc.strip().splitlines(), "wall_s": s}

        # the int8 CLI on the lock, card and CPU: equal metrics, each within
        # the JAX package's limits of float (tests/test_cli.py:84-107)
        k6_keys = (*kernels.CONV_S8_KEYS.values(), "conv_s8_quant")
        k6_before = {k: kernels.LAUNCHES[k] for k in k6_keys}
        for name, extra in (("quant", ["--quant"]),
                            ("quant_trunk", ["--quant", "--quant_trunk"]),
                            ("coattn_int8", ["--coattn_int8"]),
                            ("coattn_batch_refs", ["--coattn_batch_refs"])):
            text_q, s_q = _cli_output(cli_test.main, lock + extra, rows=LOCK_ROWS)
            text_qc, _ = _cli_output(cli_test.main, lock + extra, rows=LOCK_ROWS,
                                     platform="cpu")
            got_q, float_q = cli_metrics(text_q), cli_metrics(
                text_ls if name.startswith("quant") else text_l)
            checks[f"lock_{name}_card_equals_cpu"] = _close(
                got_q, cli_metrics(text_qc), f"lock {name}, card against CPU")
            near = (abs(got_q[1] - float_q[1]) < INT8_MIOU_TOL
                    and abs(got_q[0] - float_q[0]) < INT8_ACC_TOL)
            checks[f"lock_{name}_near_float"] = {"got": got_q, "float": float_q,
                                                 "miou_tol": INT8_MIOU_TOL,
                                                 "acc_tol": INT8_ACC_TOL, "ok": near}
            if not near:
                raise AssertionError(f"lock {name}: {got_q} against float {float_q}")
            runs[f"lock_{name}"] = {"output": text_q.strip().splitlines(),
                                    "cpu_output": text_qc.strip().splitlines(), "wall_s": s_q}
        k6_cli = {k: kernels.LAUNCHES[k] - v for k, v in k6_before.items()}
        if not kernels.conv_s8_launches(k6_cli):
            raise AssertionError("the int8 CLI runs never launched K6")
        launches.update(k6_cli)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)

    rec = {"phase": "cli", "model": "YOLOv3/Darknet-53 + BiLSTM, 256 px, emb 512, "
           "hidden 512, 5-frame windows, batch 8 (cli/test.py; eval_single on "
           "single frames); lock: mini defs, 64 px, emb/hidden 256",
           "weights": "backbone: random_darknet_weights_file(seed=0) through "
                      "--backbone_weights; rest: seeded_init_(seed=13); lock: "
                      "tests/locks/converge32tiny.npz through --resume",
           "data": f"synthetic test split, {CLI_VIDEOS} videos x {CLI_FRAMES} frames "
                   f"(.npy, seed 13): {windows} windows; lock: data/synthetic32 "
                   f"test split regenerated from seed 13 in .npy frames, first {LOCK_ROWS} rows",
           "windows": windows, "host_data_s": host_data_s,
           "model_setup_s": model_setup_s,
           "launches": launches, "launches_per_call": 12,
           "runs": runs, "checks": checks,
           "kind": torch.cuda.get_device_name(dev), "nvidia_smi": nvidia_smi()}
    emit(rec)
    return rec


# --- the C++ host loader -------------------------------------------------------

NATIVE_SHAPES = ((320, 480), (720, 1280), (13, 999))  # + a gray frame, 240x320
NATIVE_TIMED = ((320, 480), (720, 1280))
NATIVE_TIMED_FRAMES, NATIVE_TIMED_PASSES = 16, 3
# JPEG: the host loader's libjpeg against cv2's (tests/test_native.py's limit)
NATIVE_JPEG_TOL = 2.0 / 255.0 / 0.224


def _native_frames(work: str, rng) -> tuple:
    """Seeded frames as .npy (the shapes and a gray frame) and, where cv2
    is installed, the same as .jpg: (npy paths, jpg paths)."""
    npy, jpg = [], []
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in NATIVE_SHAPES]
    frames.append(rng.integers(0, 256, (240, 320), dtype=np.uint8))
    try:
        import cv2
    except ImportError:
        cv2 = None
    for i, img in enumerate(frames):
        npy.append(os.path.join(work, f"f{i}.npy"))
        np.save(npy[-1], img)
        if cv2 is not None:
            jpg.append(os.path.join(work, f"f{i}.jpg"))
            cv2.imwrite(jpg[-1], img if img.ndim == 2 else img[..., ::-1])
    return npy, jpg


def native_held(paths: list, exact: bool) -> dict:
    """`native.decode_letterbox_batch` at 256 against `read_image` ->
    `letterbox` -> `normalize_image` on the same files: bitwise (`exact`)
    or within NATIVE_JPEG_TOL, the geometry equal; `decode_batch_rgb`
    against `read_image` (bitwise where `exact`), a missing file None."""
    from dcnet_tpu_torch.data import transforms as T
    from dcnet_tpu_torch.data.vid import read_image
    images, ratios, dws, dhs, ok = native.decode_letterbox_batch(
        paths, 256, T.IMAGENET_MEAN, T.IMAGENET_STD)
    worst, geometry = 0.0, True
    for i, p in enumerate(paths):
        boxed, ratio, dw, dh = T.letterbox(read_image(p), 256)
        worst = max(worst, float(np.abs(images[i] - T.normalize_image(boxed)).max()))
        geometry &= (ratios[i], dws[i], dhs[i]) == (ratio, dw, dh)
    rgb = native.decode_batch_rgb(paths + [paths[0] + ".missing"])
    rgb_err = max(int(np.abs(a.astype(int) - read_image(p)).max())
                  for a, p in zip(rgb, paths))
    held = bool(ok.all()) and geometry and rgb[-1] is None and (
        worst == 0.0 and rgb_err == 0 if exact else worst <= NATIVE_JPEG_TOL)
    rec = {"frames": [list(np.load(p).shape) if p.endswith(".npy") else os.path.basename(p)
                      for p in paths],
           "max_abs_err": worst, "rgb_max_abs_err": rgb_err, "geometry_equal": geometry,
           "limit": 0.0 if exact else NATIVE_JPEG_TOL, "held": held}
    if not held:
        raise AssertionError(f"the host loader against the numpy path: {rec}")
    return rec


def native_frame_ms(work: str, rng) -> dict:
    """ms a frame of read + letterbox + normalize at NATIVE_TIMED's shapes:
    the numpy path serially, the core in one call on 1 thread and on
    min(n, cpu_count) threads; the best of NATIVE_TIMED_PASSES passes."""
    from dcnet_tpu_torch.data import transforms as T
    from dcnet_tpu_torch.data.vid import read_image
    out = {}
    for h, w in NATIVE_TIMED:
        paths = []
        for i in range(NATIVE_TIMED_FRAMES):
            paths.append(os.path.join(work, f"t{h}x{w}_{i}.npy"))
            np.save(paths[-1], rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        runs = {"numpy_serial": lambda: [T.normalize_image(T.letterbox(read_image(p), 256)[0])
                                         for p in paths],
                "core_1_thread": lambda: native.decode_letterbox_batch(
                    paths, 256, T.IMAGENET_MEAN, T.IMAGENET_STD, num_threads=1),
                "core_threads": lambda: native.decode_letterbox_batch(
                    paths, 256, T.IMAGENET_MEAN, T.IMAGENET_STD)}
        rec = {}
        for name, fn in runs.items():
            best = float("inf")
            for _ in range(NATIVE_TIMED_PASSES):
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
            rec[f"{name}_ms"] = 1e3 * best / len(paths)
        rec["threads"] = min(len(paths), os.cpu_count() or 1)
        out[f"{h}x{w}"] = rec
    return out


def phase_native(dev) -> dict:
    """The C++ host loader (`dcnet_tpu_torch.native`, see the module doc):
    built from the checkout, held against the numpy path, timed, and the
    full-width eval CLIs on it against the same CLIs without it."""
    import shutil
    import tempfile
    from dcnet_tpu_torch.cli import test as cli_test
    from dcnet_tpu_torch.data.synthetic import generate_synthetic_vid
    from dcnet_tpu_torch.models.darknet import random_darknet_weights_file

    if not native.available():
        raise AssertionError(f"the host loader did not build: {native.unavailable_reason()}")
    work = tempfile.mkdtemp(prefix="dcnet_native_")
    cwd = os.getcwd()
    os.chdir(work)  # setup_logging writes ./logs
    try:
        rng = np.random.default_rng(15)
        npy, jpg = _native_frames(work, rng)
        held = {"npy": native_held(npy, exact=True)}
        if "jpeg" in native.formats() and jpg:
            held["jpg"] = native_held(jpg, exact=False)
        else:
            held["jpg"] = {"held": None, "why": "not run: " + (
                "cv2 is not installed" if not jpg else native.missing(jpg[0]))}
        frame_ms = native_frame_ms(work, rng)

        root = os.path.join(work, "full")
        generate_synthetic_vid(os.path.join(root, "synthetic"), "test",
                               num_videos=CLI_VIDEOS, frames_per_video=CLI_FRAMES,
                               seed=13, frame_format="npy")
        darknet = os.path.join(work, "backbone_seed0.weights")
        random_darknet_weights_file(_defs(), darknet, seed=0)
        full = ["--synthetic", "--lstm"] + CLI_WIDTH + ["--num_frame_k", str(CLI_K),
                "--batch_size", "8", "--seed", "13", "--split_root", root,
                "--backbone_weights", darknet, "--savename", "native", "--post_process"]
        lock_root = os.path.join(work, "lock")
        generate_synthetic_vid(os.path.join(lock_root, "synthetic"), "test",
                               num_videos=32, frames_per_video=8, seed=13,
                               frame_format="npy")
        lock = ["--synthetic", "--lstm", "--mini", "--size", "64", "--emb_size", "256",
                "--lstm_hidden", "256", "--num_frame_k", str(CLI_K), "--batch_size", "4",
                "--seed", "13", "--split_root", lock_root, "--savename", "lock",
                "--resume", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                         "tests", "locks", "converge32tiny.npz")]
        runs, checks = {}, {}
        kernels.reset_launches()
        with _K1PerCall() as k1:
            for model, argv, rows in (("full", full, None), ("lock", lock, LOCK_ROWS)):
                for mode, extra, method in (("standard", [], "eval_clip"),
                                            ("stream", ["--stream_eval"], "eval_features")):
                    for core in (True, False):
                        name = f"{model}_{mode}_{'core' if core else 'numpy'}"
                        cache = (["--cache", "--cache_dir", os.path.join(work, name)]
                                 if model == "full" and mode == "standard" else [])
                        native.reset_calls()
                        saved = os.environ.pop("DCNET_NO_NATIVE", None)
                        if not core:
                            os.environ["DCNET_NO_NATIVE"] = "1"
                        try:
                            text, s = _cli_output(cli_test.main, argv + extra + cache, rows=rows,
                                                  use_native=True if core else None)
                        finally:
                            os.environ.pop("DCNET_NO_NATIVE", None)
                            if saved is not None:
                                os.environ["DCNET_NO_NATIVE"] = saved
                        calls = k1.take()
                        _expect_per_call(calls, method, f"{name} eval")
                        runs[name] = {"output": text.strip().splitlines(), "wall_s": s,
                                      "core_calls": dict(native.CALLS),
                                      f"k1_per_{method}": calls[method]}
                        if (sum(native.CALLS.values()) > 0) != core:
                            raise AssertionError(f"{name}: host loader calls {native.CALLS}")
                    got = runs[f"{model}_{mode}_numpy"]["output"]
                    want = runs[f"{model}_{mode}_core"]["output"]
                    if got != want or not all(np.isfinite(cli_metrics("\n".join(want)))):
                        raise AssertionError(f"{model} {mode} eval: {want} on the core, "
                                             f"{got} without")
                    checks[f"{model}_{mode}_core_equals_numpy"] = {"printed": want}
            launches = dict(kernels.LAUNCHES)
        if not cli_metrics("\n".join(runs["lock_standard_core"]["output"]))[1] > 0.05:
            raise AssertionError(f"the lock grounds nothing: {runs['lock_standard_core']}")
        caches = [os.path.join(work, f"full_standard_{m}", "native", "cache.npz")
                  for m in ("core", "numpy")]
        cache_rec = _cache_held(*caches)
        with np.load(caches[0], allow_pickle=True) as a, np.load(caches[1], allow_pickle=True) as b:
            cache_rec["bitwise"] = all(np.array_equal(a[k], b[k]) for k in a.files)
        checks["full_cache_core_against_numpy"] = cache_rec
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    rec = {"phase": "native", "formats": list(native.formats()), "held": held,
           "ms_per_frame": frame_ms, "cpu_count": os.cpu_count(),
           "cli": {"model": "full: as the cli phase (Darknet-53 + BiLSTM, 256 px, "
                            "emb/hidden 512, 5-frame windows, batch 8, fp32); lock: "
                            "tests/locks/converge32tiny.npz (mini defs, 64 px)",
                   "data": f"full: {CLI_VIDEOS} videos x {CLI_FRAMES} .npy frames of "
                           "320x480 (seed 13), the cli phase's split; lock: the first "
                           f"{LOCK_ROWS} rows of data/synthetic32's test split in .npy",
                   "runs": runs, "checks": checks},
           "launches": launches, "kind": torch.cuda.get_device_name(dev),
           "nvidia_smi": nvidia_smi()}
    emit(rec)
    return rec


# --- --cli-pace: the CLI's pace over longer splits ----------------------------

PACE_SPLITS = (  # frame height, width, videos; 20 frames a video, 15 windows
    (320, 480, 24),     # the synthetic generator's frames: 360 windows
    (720, 1280, 8),     # a 720p frame, as most of ImageNet VID's: 120 windows
)
PACE_FRAMES, PACE_WORKERS = 20, 8
# (run, flags, the decode pool the CLI does not use, the datasets' use_native):
# the numpy runs (serial, --workers threads, worker processes, the stream
# eval), then the same CLI on the C++ host loader
PACE_MODES = (("serial", ["--workers", "0"], None, False),
              ("workers", ["--workers", str(PACE_WORKERS)], None, False),
              ("processes", ["--workers", str(PACE_WORKERS)], "_process_batches", False),
              ("stream", ["--stream_eval"], None, False),
              ("core_serial", ["--workers", "0"], "_recorded_batches", True),
              ("core_workers", ["--workers", str(PACE_WORKERS)], None, True),
              ("core_stream", ["--stream_eval"], None, True),
              # the same loop without decoding: core_serial's batches replayed from
              # host memory (collate done; the pinned copy and H2D still paid) and
              # from the card (the loop's own host work and the model alone)
              ("replay_host", ["--workers", "0"], "_replayed_batches", None),
              ("replay_card", ["--workers", "0"], "_replayed_batches", None))
_PACE_DS = None
_PACE_BATCHES: list = []   # core_serial's batches, replayed by the replay runs


def _recorded_batches(*a, **k):
    """`data.vid.batch_iterator`, keeping each batch in _PACE_BATCHES."""
    from dcnet_tpu_torch.data.vid import batch_iterator
    _PACE_BATCHES.clear()
    for batch in batch_iterator(*a, **k):
        _PACE_BATCHES.append(batch)
        yield batch


def _replayed_batches(*_, **__):
    return iter(_PACE_BATCHES)


def _on_card(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            if isinstance(v, np.ndarray) and v.dtype != object else v
            for k, v in batch.items()}


def _pace_worker_init(dataset) -> None:
    global _PACE_DS
    _PACE_DS = dataset


def _pace_worker_get(idx: int):
    return _PACE_DS[idx]


def _process_batches(dataset, batch_size, drop_last=False, num_workers=0, **_):
    """The decode pool the CLI does not use, for the comparison: the batches
    of `data.vid.batch_iterator` (in order, not shuffled, one shard)
    decoded by `num_workers` worker processes. The caller holds threads and
    a CUDA context, so it is never forked: the workers fork from
    multiprocessing's fork server, which imports the data module once, and
    the dataset is pickled to each."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["dcnet_tpu_torch.data.vid"])
    n = len(dataset)
    with ProcessPoolExecutor(num_workers, mp_context=ctx, initializer=_pace_worker_init,
                             initargs=(dataset,)) as pool:
        for start in range(0, n, batch_size):
            idxs = list(range(start, min(start + batch_size, n)))
            if len(idxs) < batch_size and drop_last:
                break
            items = list(pool.map(_pace_worker_get, idxs, chunksize=1))
            yield {k: (np.stack([it[k] for it in items])
                       if isinstance(items[0][k], np.ndarray) else [it[k] for it in items])
                   for k in items[0]}


class _EvalLoop:
    """The eval loop of one cli/test.py run: the host time it began (the
    first `batch_iterator` or `_stream_eval` call, after the model is
    built), and the card's busy time in it, summed from torch.profiler's
    device activities (kernels and copies; the profiler starts with the
    loop, so set-up is not counted)."""

    def __init__(self, cli_test):
        self.mod, self.t0, self.prof = cli_test, None, None
        self.orig = {n: getattr(cli_test, n) for n in ("batch_iterator", "_stream_eval")}

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        for name, fn in self.orig.items():
            def started(*a, _fn=fn, **k):
                if self.t0 is None:
                    torch.cuda.synchronize()
                    self.prof = profile(activities=[ProfilerActivity.CUDA])
                    self.prof.start()
                    self.t0 = time.perf_counter()
                return _fn(*a, **k)
            setattr(self.mod, name, started)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)

    def finish(self) -> tuple:
        """(loop seconds, device-busy seconds), the run synchronised."""
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - self.t0
        self.prof.stop()
        busy_us = sum(e.self_device_time_total for e in self.prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        return loop_s, busy_us / 1e6


def phase_cli_pace(dev) -> dict:
    """The full-width standard and stream evals of cli/test.py over longer
    synthetic splits (PACE_SPLITS, .npy frames), fp32 and bf16; the
    standard eval's frames decoded in numpy serially (--workers 0), by the
    CLI's --workers threads and by worker processes (`_process_batches`),
    then on the C++ host loader (serially and in the threads; and the
    stream eval on it, a video a call), then the serial loop replaying
    the host loader's batches from host memory and from the card (no
    decode: what the loop costs without it). Per run: the wall time (set-up
    included), the eval loop's time and clips/s, the card's busy time in
    the loop (torch.profiler) and its share of the loop, the host loader's
    calls; per split the read + letterbox + normalize time of one frame,
    numpy serially and the core on 1 and on min(40, cpu_count) threads.
    Every decode of a split must print the same metrics."""
    import shutil
    import tempfile
    from dcnet_tpu_torch.cli import test as cli_test
    from dcnet_tpu_torch.data import transforms as T
    from dcnet_tpu_torch.data.synthetic import generate_synthetic_vid
    from dcnet_tpu_torch.data.vid import get_chunks, load_index, read_image
    from dcnet_tpu_torch.models.darknet import random_darknet_weights_file

    work = tempfile.mkdtemp(prefix="dcnet_pace_")
    cwd = os.getcwd()
    os.chdir(work)  # setup_logging writes ./logs
    splits = []
    try:
        darknet = os.path.join(work, "backbone_seed0.weights")
        random_darknet_weights_file(_defs(), darknet, seed=0)
        for h, w, videos in PACE_SPLITS:
            root = os.path.join(work, f"{h}x{w}")
            index = generate_synthetic_vid(os.path.join(root, "synthetic"), "test",
                                           num_videos=videos, frames_per_video=PACE_FRAMES,
                                           height=h, width=w, seed=13, frame_format="npy")
            frames_dir = os.path.join(root, "synthetic", "frames")
            names = [os.path.join(frames_dir, n) for n in sorted(os.listdir(frames_dir))[:40]]
            t0 = time.perf_counter()
            for name in names:
                T.normalize_image(T.letterbox(read_image(name), 256)[0])
            frame_ms = 1e3 * (time.perf_counter() - t0) / len(names)
            core_ms = {}
            for threads in (1, 0):
                t0 = time.perf_counter()
                native.decode_letterbox_batch(names, 256, T.IMAGENET_MEAN, T.IMAGENET_STD,
                                              num_threads=threads)
                core_ms[f"threads_{threads or min(len(names), os.cpu_count())}"] = \
                    1e3 * (time.perf_counter() - t0) / len(names)
            windows = len(get_chunks(load_index(index), "test", CLI_K))
            argv = ["--synthetic", "--lstm"] + CLI_WIDTH + [
                "--num_frame_k", str(CLI_K), "--batch_size", "8", "--seed", "13",
                "--split_root", root, "--backbone_weights", darknet, "--savename", "pace"]
            runs = {}
            for dt in ("fp32", "bf16"):
                dtf = ["--bf16"] if dt == "bf16" else []
                for mode, extra, batches, core in PACE_MODES:
                    saved = cli_test.batch_iterator
                    if batches is not None:
                        cli_test.batch_iterator = globals()[batches]
                    if mode == "replay_host":
                        host_batches = list(_PACE_BATCHES)
                    if mode == "replay_card":   # moved before the loop's clock starts
                        _PACE_BATCHES[:] = [_on_card(b, dev) for b in host_batches]
                        torch.cuda.synchronize()
                    native.reset_calls()
                    try:
                        with _EvalLoop(cli_test) as loop:
                            text, wall = _cli_output(cli_test.main, argv + dtf + extra,
                                                     use_native=core)
                            loop_s, busy_s = loop.finish()
                    finally:
                        cli_test.batch_iterator = saved
                    calls = sum(native.CALLS.values())
                    if (calls > 0) != bool(core):
                        raise AssertionError(f"{h}x{w} {dt} {mode}: host loader calls "
                                             f"{native.CALLS}")
                    metrics = cli_metrics(text)
                    runs[f"{dt}_{mode}"] = {
                        "metrics": metrics, "wall_s": wall, "eval_s": loop_s,
                        "clips_per_s": windows / loop_s, "device_busy_s": busy_s,
                        "device_busy_share": busy_s / loop_s, "host_loader_calls": calls}
                    emit({"phase": "cli_pace", "frames": f"{h}x{w}", "run": f"{dt}_{mode}",
                          **runs[f"{dt}_{mode}"]})
                _PACE_BATCHES.clear()
                want = runs[f"{dt}_serial"]["metrics"]
                for mode in ("workers", "processes", "core_serial", "core_workers",
                             "replay_host", "replay_card"):
                    if runs[f"{dt}_{mode}"]["metrics"] != want:
                        raise AssertionError(f"{h}x{w} {dt}: {mode} decode printed "
                                             f"{runs[f'{dt}_{mode}']['metrics']}, serial {want}")
                if runs[f"{dt}_core_stream"]["metrics"] != runs[f"{dt}_stream"]["metrics"]:
                    raise AssertionError(f"{h}x{w} {dt}: the stream eval on the core printed "
                                         f"{runs[f'{dt}_core_stream']['metrics']}, without "
                                         f"{runs[f'{dt}_stream']['metrics']}")
                _close(runs[f"{dt}_stream"]["metrics"], want, f"{h}x{w} {dt} stream")
            splits.append({"frames": f"{h}x{w}", "videos": videos,
                           "frames_per_video": PACE_FRAMES, "windows": windows,
                           "letterbox_ms_per_frame": frame_ms,
                           "host_loader_ms_per_frame": core_ms, "runs": runs})
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    rec = {"phase": "cli_pace", "workers": PACE_WORKERS, "cpu_count": os.cpu_count(),
           "model": "as the cli phase: Darknet-53 + BiLSTM, 256 px, emb/hidden 512, "
                    "5-frame windows, batch 8",
           "splits": splits, "kind": torch.cuda.get_device_name(dev),
           "nvidia_smi": nvidia_smi()}
    emit(rec)
    return rec


# --- the serving bundle, the serve CLI and data parallelism ------------------

EXPORT_TICKS = 12                 # every slot value of the 5-frame ring twice
EXPORT_TOL = 1e-4                 # runtime against the live engine (tests/test_serving.py)
EXPORT_SEED = 11
SERVE_CLI_STREAMS, SERVE_CLI_TICKS = 4, 6
SERVE_CLI_PACE = (16, 24)         # streams, ticks of the predictions/s runs

# the bundle's runtime in a fresh process: loads each bundle of the spec,
# serves the spec's seeded frames tick by tick (launches per tick), times
# chains of ticks as the serving phase does, and reports the modules of
# dcnet_tpu_torch it imported
_RUNTIME_WORKER = r"""
import json, sys, time
import numpy as np, torch
from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.serving.export import ServingRuntime

spec = json.loads(open(sys.argv[1]).read())
dev = torch.device(spec["device"])
torch.backends.cuda.matmul.allow_tf32 = False   # as the device phase sets them
torch.backends.cudnn.allow_tf32 = False


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


ids = torch.from_numpy(np.load(spec["ids"])).to(dev)
out, report = {}, {}
for name, path in spec["bundles"].items():
    t0 = time.perf_counter()
    rt = ServingRuntime(path, device=dev)
    sync()
    load_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    n, size = spec["streams"], spec["size"]
    state = rt.init_state(ids)
    per_tick = []
    for t in range(spec["ticks"]):
        frames = torch.rand((n, size, size, 3), generator=gen, device=dev)
        before = dict(kernels.LAUNCHES)
        state, fused, raw, score = rt.step(state, frames)
        per_tick.append({k: kernels.LAUNCHES[k] - before[k] for k in before})
        for k, v in (("fused", fused), ("raw", raw), ("score", score)):
            out[f"{name}/{k}/{t}"] = v.float().cpu().numpy()
    frames = torch.rand((n, size, size, 3), generator=gen, device=dev)
    for _ in range(spec["warmup"]):
        state, *_ = rt.step(state, frames)
    chains = []
    for _ in range(spec["chains"]):
        sync()
        t1 = time.perf_counter()
        for _ in range(spec["chain_ticks"]):
            state, *_ = rt.step(state, frames)
        sync()
        chains.append((time.perf_counter() - t1) / spec["chain_ticks"])
    report[name] = {"load_s": load_s, "launches_per_tick": per_tick,
                    "s_per_tick": float(np.median(chains)), "s_per_tick_chains": chains}
    del rt, state
np.savez(spec["out"], **out)
report["modules"] = sorted(m for m in sys.modules if m.startswith("dcnet_tpu_torch"))
print(json.dumps(report))
"""


def _timed_ticks(step, state, frames, sync) -> tuple:
    """The serving phase's timing: WARMUP_TICKS, then the median of
    TIMED_CHAINS chains of CHAIN_TICKS ticks: (state, s/tick, chains)."""
    for _ in range(WARMUP_TICKS):
        state, *_ = step(state, frames)
    chains = []
    for _ in range(TIMED_CHAINS):
        sync()
        t1 = time.perf_counter()
        for _ in range(CHAIN_TICKS):
            state, *_ = step(state, frames)
        sync()
        chains.append((time.perf_counter() - t1) / CHAIN_TICKS)
    return state, float(np.median(chains)), chains


def _per_tick_equal(got: list, want: list, first_tick_pads: bool) -> list:
    """Ticks whose launches differ. On the first tick the runtime pads its
    constant weights once where the live engine's were padded before (by
    the export's warm-up), so there its quantize passes may exceed the
    live engine's; every other count, and every count of a later tick,
    is equal."""
    bad = []
    for t, (g, w) in enumerate(zip(got, want)):
        keys = [k for k in g if not (t == 0 and first_tick_pads and k == "conv_s8_quant")]
        if any(g[k] != w[k] for k in keys) or (
                t == 0 and g["conv_s8_quant"] < w["conv_s8_quant"]):
            bad.append({"tick": t, "runtime": g, "live": w})
    return bad


def phase_export(dev) -> dict:
    """The serving bundle on the card (`serving/export.py`): the serving
    phase's full-width bf16 model at 120 streams, exported as a float
    engine with int8 rings on K4, as a float K1 engine, and after
    `quantize()` (int8 backbone and trunk) with int8 rings on K4; each
    bundle loaded and served in one fresh process that imports no model
    module (`_RUNTIME_WORKER`), EXPORT_TICKS ticks on the live engine's
    seeded frames: raw and fused boxes and scores within EXPORT_TOL of the
    live engine each tick, the same launches each tick (`_per_tick_equal`);
    export and load seconds, s/tick of the runtime beside the live
    engine's (timed before the export, the ratio's base, and after it)."""
    import shutil
    import tempfile
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.serving.engine import GroundingEngine, cast_params_for_serving
    from dcnet_tpu_torch.serving.export import export_engine

    cfg = serving_config(compute_dtype="bfloat16", coattn_multiref=True)
    size, n = cfg.image_size, SERVE_STREAMS
    model, defs, setup_s = seeded_model(cfg, dev)
    cast_params_for_serving(model)
    k1_model = DCNet(cfg.replace(coattn_multiref=False), backbone_defs=defs, device=dev)
    k1_model.load_state_dict(model.state_dict())
    ids = _phrases(np.random.RandomState(3), cfg, n)
    work = tempfile.mkdtemp(prefix="dcnet_export_")
    np.save(os.path.join(work, "ids.npy"), ids.numpy())
    ids = ids.to(dev)
    variants, live = {}, {}
    try:
        for name in ("float", "k1", "quantized"):
            if name == "quantized":
                t0 = time.perf_counter()
                gen = torch.Generator(device=dev).manual_seed(3)
                calib = torch.rand((16, size, size, 3), generator=gen, device=dev)
                eng = GroundingEngine(model, n, int8_rings=True).quantize(calib, ids[:1])
                torch.cuda.synchronize()
                quantize_s = time.perf_counter() - t0
            else:
                eng = GroundingEngine(k1_model if name == "k1" else model, n,
                                      int8_rings=name == "float")
            # the live engine's s/tick before the export too: the runtime is
            # held against it, and the reading after the export shows the
            # tick's spread within one process
            pre = torch.rand((n, size, size, 3), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(EXPORT_SEED + 1))
            _, before_s, before_chains = _timed_ticks(eng.step, eng.init_state(ids), pre,
                                                      torch.cuda.synchronize)
            del pre
            t0 = time.perf_counter()
            meta = export_engine(eng, os.path.join(work, name))
            export_s = time.perf_counter() - t0
            gen = torch.Generator(device=dev).manual_seed(EXPORT_SEED)
            state, per_tick, outs = _serve(eng, ids, EXPORT_TICKS, lambda _t: torch.rand(
                (n, size, size, 3), generator=gen, device=dev))
            live[name] = {"per_tick": per_tick,
                          "outs": [[x.float().cpu() for x in o] for o in outs]}
            frames = torch.rand((n, size, size, 3), generator=gen, device=dev)
            _, s_tick, chains = _timed_ticks(eng.step, state, frames, torch.cuda.synchronize)
            variants[name] = {"export_s": export_s, "live_s_per_tick": s_tick,
                              "live_s_per_tick_chains": chains,
                              "live_before_export_s_per_tick": before_s,
                              "live_before_export_chains": before_chains, "meta": meta,
                              "bundle_mib": sum(os.path.getsize(os.path.join(work, name, f))
                                                for f in os.listdir(os.path.join(work, name)))
                              / 2**20}
            if name == "quantized":
                variants[name]["quantize_s"] = quantize_s
            del state, eng, outs
        kernels.reset_launches()
        spec = {"bundles": {k: os.path.join(work, k) for k in variants}, "device": str(dev),
                "ids": os.path.join(work, "ids.npy"), "seed": EXPORT_SEED,
                "streams": n, "size": size, "ticks": EXPORT_TICKS,
                "warmup": WARMUP_TICKS, "chains": TIMED_CHAINS, "chain_ticks": CHAIN_TICKS,
                "out": os.path.join(work, "served.npz")}
        with open(os.path.join(work, "spec.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _RUNTIME_WORKER,
                               os.path.join(work, "spec.json")], capture_output=True,
                              text=True, timeout=600, cwd=os.path.dirname(
                                  os.path.abspath(__file__)))
        worker_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the runtime process failed: {proc.stderr[-3000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        served = np.load(spec["out"])
        models = [m for m in report["modules"] if m.startswith("dcnet_tpu_torch.models")
                  or m == "dcnet_tpu_torch.serving.engine"]
        if models:
            raise AssertionError(f"the runtime process imported model code: {models}")
        for name, v in variants.items():
            worst = 0.0
            for t, want in enumerate(live[name]["outs"]):
                for k, w in zip(("fused", "raw", "score"), want):
                    worst = max(worst, float(np.abs(served[f"{name}/{k}/{t}"]
                                                    - w.numpy()).max()))
            if worst > EXPORT_TOL:
                raise AssertionError(f"export {name}: the runtime is {worst} from the "
                                     f"live engine (limit {EXPORT_TOL})")
            rt = report[name]
            bad = _per_tick_equal(rt["launches_per_tick"], live[name]["per_tick"],
                                  first_tick_pads=name == "quantized")
            if bad:
                raise AssertionError(f"export {name}: launches differ: {bad[:2]}")
            v.update(max_abs_diff=worst, load_s=rt["load_s"],
                     runtime_s_per_tick=rt["s_per_tick"],
                     runtime_s_per_tick_chains=rt["s_per_tick_chains"],
                     runtime_over_live=rt["s_per_tick"] / v["live_before_export_s_per_tick"],
                     live_after_over_before_export=(v["live_s_per_tick"]
                                                    / v["live_before_export_s_per_tick"]),
                     launches_per_tick=rt["launches_per_tick"][-1],
                     launches=_sum_counts(rt["launches_per_tick"]))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernels.reset_launches()
    rec = {"phase": "export", "model": "the serving phase's (bf16, cast for serving, 120 "
           "streams, rotating rings, split_corr_conv off)", "setup_s": setup_s,
           "ticks": EXPORT_TICKS, "tol": EXPORT_TOL, "worker_s": worker_s,
           "runtime_modules": report["modules"], "variants": variants,
           "kind": torch.cuda.get_device_name(dev), "nvidia_smi": nvidia_smi()}
    emit(rec)
    return rec


def _sum_counts(per_tick: list) -> dict:
    return {k: sum(t[k] for t in per_tick) for k in per_tick[0]}


class _RecordedTicks:
    """Inside the `with`, `cli.serve`'s engine records each tick's outputs
    (on the CPU) and launches."""

    def __init__(self):
        from dcnet_tpu_torch.cli import serve
        self.mod, self.ticks, self.launches = serve, [], []

    def __enter__(self):
        real = self.real = self.mod.GroundingEngine
        ticks, launches = self.ticks, self.launches

        class Recorded(real):
            def step(self, state, frames):
                before = dict(kernels.LAUNCHES)
                out = super().step(state, frames)
                launches.append({k: kernels.LAUNCHES[k] - before[k] for k in before})
                ticks.append([x.float().cpu() for x in out[1:]])
                return out

        self.mod.GroundingEngine = Recorded
        return self

    def __exit__(self, *exc):
        self.mod.GroundingEngine = self.real
        return False


def _serve_cli(argv, platform=None) -> dict:
    """cli/serve.py's `main` in-process: its ticks, launches, decode taps,
    stdout and seconds."""
    from dcnet_tpu_torch.cli import serve
    kernels.reset_launches()
    with _RecordedTicks() as rec, DecodeTaps() as taps:
        text, seconds = _cli_output(serve.main, argv, platform=platform)
    return {"ticks": rec.ticks, "launches": rec.launches, "taps": taps.taps,
            "text": text, "s": seconds}


def _pace(text: str) -> float:
    return float(re.findall(r": (\S+) predictions/s", text)[-1])


def phase_serve_cli(dev) -> dict:
    """cli/serve.py in-process at full width (Darknet-53 from a seeded
    `.weights` file, 256 px, emb 512) on --synthetic streams (`.npy`
    frames): the BiLSTM and the BERT engine, float and --quant, card
    against the CPU on SERVE_CLI_STREAMS fp32 streams (float: boxes and
    scores within SERVE_TOL each tick; --quant, whose trunk PTQ flips
    codes: `serve_cells_held`, as the serving_int8 phase holds its tick);
    --state_file stopped after half the
    ticks and resumed against the uninterrupted run; --export_bundle;
    predictions/s at SERVE_CLI_PACE streams (float and --quant)."""
    import shutil
    import tempfile
    from dcnet_tpu_torch.models.darknet import random_darknet_weights_file

    work = tempfile.mkdtemp(prefix="dcnet_serve_cli_")
    cwd = os.getcwd()
    os.chdir(work)  # ./cache (the synthetic streams) and ./logs
    try:
        darknet = os.path.join(work, "backbone_seed0.weights")
        random_darknet_weights_file(_defs(), darknet, seed=0)
        base = CLI_WIDTH + ["--synthetic", "--seed", "13", "--print_every", "100",
                            "--backbone_weights", darknet, "--topk", "5",
                            "--fuse_window", "5"]
        encoders = {"lstm": ["--lstm"], "bert": ["--bert_model", BERT_MODEL]}
        par = ["--n_streams", str(SERVE_CLI_STREAMS), "--ticks", str(SERVE_CLI_TICKS)]
        runs = {}
        for enc, flags in encoders.items():
            for quant in (False, True):
                name = f"{enc}{'_quant' if quant else ''}"
                argv = base + flags + par + (["--quant"] if quant else [])
                card = _serve_cli(argv)
                want = {"coattn_attend": 12}
                if quant:
                    want["k6_convs"] = backbone_k6_per_call() + trunk_k6_per_call(
                        serving_config())
                for t, got in enumerate(card["launches"]):
                    if launches_differ({**got, "conv_s8_quant": 0}, want):
                        raise AssertionError(f"serve CLI {name}: tick {t} launched {got}")
                _finite(card["ticks"], f"serve CLI {name}")
                run = {"card_s": card["s"], "launches": _sum_counts(card["launches"]),
                       "ticks": len(card["ticks"])}
                cpu = _serve_cli(argv, platform="cpu")
                run["cpu_s"] = cpu["s"]
                if quant:
                    held = serve_cells_held(card["taps"], cpu["taps"],
                                            full_width_config().strides,
                                            INT8_PARITY_TOL["atol"], SERVE_TOL["atol"])
                    if not held["ok"]:
                        raise AssertionError(f"serve CLI {name}, card against CPU: "
                                             f"{held}")
                    run["cpu_parity"] = held
                else:
                    worst = 0.0
                    for a_tick, b_tick in zip(card["ticks"], cpu["ticks"]):
                        for a, b in zip(a_tick, b_tick):
                            torch.testing.assert_close(a, b, **SERVE_TOL)
                            worst = max(worst, (a - b).abs().max().item())
                    run["cpu_parity"] = {"max_abs_err": worst, "tol": SERVE_TOL}
                runs[name] = run
                if name == "lstm":
                    uninterrupted = card
                del card

        # --state_file: stop after half the ticks, resume to the end
        half = SERVE_CLI_TICKS // 2
        lstm = base + encoders["lstm"] + ["--n_streams", str(SERVE_CLI_STREAMS)]
        _serve_cli(lstm + ["--ticks", str(half), "--state_file", "s.npz",
                           "--state_every", "1"])
        resumed = _serve_cli(lstm + ["--ticks", str(SERVE_CLI_TICKS),
                                     "--state_file", "s.npz"])
        if "resumed stream state" not in resumed["text"] or \
                len(resumed["ticks"]) != SERVE_CLI_TICKS - half:
            raise AssertionError(f"serve CLI resume: {resumed['text'][-500:]}")
        diff = max((a - b).abs().max().item()
                   for got, want in zip(resumed["ticks"], uninterrupted["ticks"][half:])
                   for a, b in zip(got, want))
        if diff > EXPORT_TOL:
            raise AssertionError(f"serve CLI resume differs by {diff}")
        resume = {"ticks_resumed": SERVE_CLI_TICKS - half, "max_abs_diff": diff,
                  "bitwise": diff == 0.0, "tol": EXPORT_TOL}

        # --export_bundle (the export phase serves bundles)
        t0 = time.perf_counter()
        _serve_cli(lstm + ["--ticks", "1", "--export_bundle", "bundle"])
        with open(os.path.join("bundle", "meta.json")) as f:
            meta = json.load(f)
        if sorted(os.listdir("bundle")) != ["encode_lang.pt2", "meta.json", "step.pt2"] \
                or meta["platforms"] != [dev.type] or meta["n_streams"] != SERVE_CLI_STREAMS:
            raise AssertionError(f"serve CLI --export_bundle wrote {os.listdir('bundle')}, "
                                 f"{meta}")
        bundle = {"s": time.perf_counter() - t0, "meta": meta}

        # predictions/s at SERVE_CLI_PACE streams
        streams, ticks = SERVE_CLI_PACE
        pace = {}
        for quant in (False, True):
            r = _serve_cli(lstm[:-2] + ["--n_streams", str(streams), "--ticks", str(ticks),
                                        "--print_every", str(ticks)]
                           + (["--quant"] if quant else []))
            pace["quant" if quant else "float"] = {
                "streams": streams, "ticks": ticks, "predictions_per_s": _pace(r["text"]),
                "wall_s": r["s"], "note": "the CLI's own count: every tick from the first, "
                                          "host frame stacking included"}
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    kernels.reset_launches()
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in kernels.LAUNCHES}
    rec = {"phase": "serve_cli", "streams": SERVE_CLI_STREAMS, "ticks": SERVE_CLI_TICKS,
           "runs": runs, "resume": resume, "export_bundle": bundle, "pace": pace,
           "launches": launches, "argv": base, "kind": torch.cuda.get_device_name(dev),
           "nvidia_smi": nvidia_smi()}
    emit(rec)
    return rec


DDP_CLIPS = 4                     # clips of the DDP train step against the plain one


DDP_RANKS = 2                     # gloo processes sharing the card: the two-process step
DP_LOSS_RTOL = 1e-3               # the JAX package's data-parallel limits,
DP_METRIC_RTOL, DP_METRIC_ATOL = 5e-3, 1e-5   # tests/test_train.py:171-177
DP_METRICS = ("acc50", "miou", "loss_yolo", "loss_interframe")
DP_GRAD_FLOOR = 1e-3              # train_parity's floor of a module's gradient limit
DP_STATS_RTOL, DP_STATS_ATOL = 1e-5, 1e-6


def _dp_flags(on: bool = True):
    """fp32 without TF32, cuDNN deterministic: the two-process step and
    the one-process step it is held against compute alike. Returns the
    flags before."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = not on
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = on, not on
    return before


def _dp_step(cfg, weights, batch, dev, rows, ddp: bool, moments: str = "global"):
    """One fp32 train step from `weights` on `rows` of the flattened
    `batch` (deterministic negatives), plain or through
    DistributedDataParallel in the current group. `moments`: "global"
    (the code as it is), "per_process" (each process's own BatchNorm
    moments, `mesh.bn_group` None: plain DDP) or "summed" (one process
    through the data-parallel BatchNorm's sums, the all-reduce the
    identity: another fp32 evaluation of the one-process step). Returns
    (metrics averaged over the ranks, gradients, BatchNorm running
    statistics, launches)."""
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.parallel import mesh
    from dcnet_tpu_torch.train.state import create_train_state
    from dcnet_tpu_torch.train.step import train_step

    model = DCNet(cfg, backbone_defs=_defs(), device=dev)
    model.load_state_dict(weights)
    state = create_train_state(model, cfg, steps_per_epoch=10)
    if ddp:
        state.ddp = mesh.wrap_ddp(model, dev)
    part = {k: v[rows] for k, v in batch.items()}
    real = mesh.bn_group, mesh.all_reduce_sum
    if moments == "per_process":
        mesh.bn_group = lambda bn: None
    elif moments == "summed":
        mesh.bn_group, mesh.all_reduce_sum = (lambda bn: "one"), (lambda x, group=None: x)
    kernels.reset_launches()
    torch.manual_seed(0)  # the same dropout masks
    try:
        metrics = mesh.mean_over_ranks(train_step(state, part))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        mesh.bn_group, mesh.all_reduce_sum = real
    launches = dict(kernels.LAUNCHES)
    grads = {n: q.grad.detach().clone() for n, q in model.named_parameters()
             if q.grad is not None}
    stats = {n: b.detach().clone() for n, b in model.named_buffers() if "running" in n}
    return {k: float(v) for k, v in metrics.items()}, grads, stats, launches


def _dp_rows(batch, rank: int) -> slice:
    per = batch["images"].shape[0] // DDP_RANKS
    return slice(rank * per, (rank + 1) * per)


def _gloo_rank(i: int, init: str, work: str) -> None:
    """Rank i + 1 of the two-process step (spawned, on the same card): its
    rows of the global batch, with the global-batch BatchNorm and with
    per-process moments; writes its metrics and running statistics (its
    gradients are rank 0's: DDP all-reduces them)."""
    import torch.distributed as dist

    rank = i + 1
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    dev = torch.device(inputs["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _dp_flags()
    correspondence._sample_negatives_excluding = _deterministic_negatives
    dist.init_process_group("gloo", init_method=init, world_size=DDP_RANKS, rank=rank)
    try:
        out = {}
        for name in ("global", "per_process"):
            m, _, st, _ = _dp_step(inputs["cfg"], inputs["weights"], inputs["batch"], dev,
                                   _dp_rows(inputs["batch"], rank), True, name)
            out[name] = {"metrics": m, "stats": {k: v.cpu() for k, v in st.items()}}
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _dp_within(got: dict, want: dict) -> bool:
    """The JAX package's data-parallel limits: loss rtol 1e-3; acc50,
    miou, loss_yolo, loss_interframe rtol 5e-3 / atol 1e-5."""
    ok = abs(got["loss"] - want["loss"]) <= DP_LOSS_RTOL * abs(want["loss"])
    return ok and all(abs(got[k] - want[k]) <= DP_METRIC_ATOL + DP_METRIC_RTOL * abs(want[k])
                      for k in DP_METRICS)


def _module_distances(got: dict, want: dict) -> dict:
    """Each top-level module's gradient: relative l2 distance of `got`
    from `want`."""
    d2, n2 = {}, {}
    for n, g in want.items():
        m = n.split(".")[0]
        d2[m] = d2.get(m, 0.0) + float((got[n] - g).double().norm()) ** 2
        n2[m] = n2.get(m, 0.0) + float(g.double().norm()) ** 2
    return {m: (d2[m] / n2[m]) ** 0.5 if n2[m] else d2[m] ** 0.5 for m in d2}


def two_process_step(cfg, weights, batch, dev, work: str) -> dict:
    """Two processes on the one card, joined by gloo over CUDA tensors
    (this one rank 0, one spawned): one fp32 train step of DDP_CLIPS
    clips, each rank its half, through DistributedDataParallel with the
    global-batch BatchNorm (all-reduced moments, `_AllReduceSum`'s
    backward) and the all-gathered flip, held against the one-process
    step on the global batch at the JAX package's data-parallel limits,
    running statistics equal on both ranks and within DP_STATS_RTOL of the
    one-process step's, and each module's gradient within max(1e-3, 2 d)
    relative l2, d its distance between two fp32 evaluations of the
    one-process step (cuDNN's fused BatchNorm and the data-parallel sums,
    `moments="summed"`): `train_parity`'s rule, whose float64 step shows
    that at full width 75 train-mode BatchNorms turn fp32 rounding into
    ~1e-2 of the backbone's gradient on any fp32 path. The same ranks then
    take the step with per-process moments (plain DDP), reported beside."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    cfg = cfg.replace(jemb_dropout=0.0, input_dropout=0.0)  # no masks to pair
    before = _dp_flags()
    t0 = time.perf_counter()
    try:
        one = _dp_step(cfg, weights, batch, dev, slice(None), ddp=False)
        summed = _dp_step(cfg, weights, batch, dev, slice(None), False, "summed")
        torch.save({"cfg": cfg, "weights": weights, "batch": batch, "device": str(dev)},
                   os.path.join(work, "inputs.pt"))
        init = "file://" + os.path.join(work, "store")
        ctx = mp.start_processes(_gloo_rank, args=(init, work), nprocs=DDP_RANKS - 1,
                                 join=False, start_method="spawn")
        try:
            dist.init_process_group("gloo", init_method=init, world_size=DDP_RANKS, rank=0)
            try:
                mine = {name: _dp_step(cfg, weights, batch, dev, _dp_rows(batch, 0), True,
                                       name)
                        for name in ("global", "per_process")}
            finally:
                dist.destroy_process_group()
        except BaseException:
            for proc in ctx.processes:  # they would wait on rank 0's collectives
                proc.terminate()
            raise
        while not ctx.join():
            pass
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = before
    others = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
              for r in range(1, DDP_RANKS)]
    want_m, want_g, want_st = one[0], one[1], one[2]
    noise = _module_distances(summed[1], want_g)
    limit = {m: max(DP_GRAD_FLOOR, 2 * d) for m, d in noise.items()}
    rec = {"ranks": DDP_RANKS, "backend": "gloo (CUDA tensors, one card)",
           "clips": DDP_CLIPS, "dropout": 0.0, "tf32": False,
           "limits": {"loss_rtol": DP_LOSS_RTOL, "metrics": [DP_METRIC_RTOL, DP_METRIC_ATOL],
                      "stats": [DP_STATS_RTOL, DP_STATS_ATOL], "grad_rel_l2": limit},
           "one_process_metrics": want_m, "summed_metrics": summed[0],
           "grad_rel_l2_summed_vs_one": noise, "launches": mine["global"][3],
           "one_process_launches": one[3]}
    for name in ("global", "per_process"):
        got_m, got_g, got_st = mine[name][:3]
        dist_m = _module_distances(got_g, want_g)
        stats_equal = all(torch.equal(o[name]["stats"][k], v.cpu())
                          for o in others for k, v in got_st.items())
        stats_err = max(((v.double() - want_st[k].double()).abs()
                         - DP_STATS_RTOL * want_st[k].double().abs()).max().item()
                        for k, v in got_st.items())
        rec[name] = {"metrics": got_m,
                     "within_jax_limits": all(_dp_within(m, want_m) for m in
                                              [got_m] + [o[name]["metrics"] for o in others]),
                     "grad_rel_l2": dist_m,
                     "modules_beyond_limit": sorted(m for m, d in dist_m.items()
                                                    if d > limit[m]),
                     "stats_equal_on_every_rank": stats_equal,
                     "stats_excess_over_rtol": stats_err}
    rec["seconds"] = time.perf_counter() - t0
    g = rec["global"]
    if not (g["within_jax_limits"] and not g["modules_beyond_limit"]
            and g["stats_equal_on_every_rank"] and g["stats_excess_over_rtol"] <= DP_STATS_ATOL
            and rec["launches"]["coattn_pair"] and rec["launches"]["coattn_attend_bwd"]):
        raise AssertionError(f"the two-process step misses the one-process step: {rec}")
    return rec


def phase_ddp(dev) -> dict:
    """Data parallelism on one card: a NCCL group of one. One fp32 train
    step of the full-width model on DDP_CLIPS k=2 clips through
    DistributedDataParallel against the plain step from the same weights
    (metrics, every gradient and BatchNorm running statistic, bitwise with
    torch's deterministic algorithms and cuDNN deterministic, as the
    train_cli phase's resume); `cli/train.py --devices 1` (DDP in a group
    of one) against the plain run and a second plain run (the card's
    run-to-run spread, `RESUME_SPREAD`). Then two processes on the one
    card joined by gloo (`two_process_step`): the global-batch BatchNorm,
    its backward and the all-gathered flip on CUDA tensors, held against
    the one-process step. Two cards cannot run on a one-card machine: the
    phase says so."""
    import contextlib
    import io
    import shutil
    import tempfile
    from dcnet_tpu_torch.cli import train as cli_train
    from dcnet_tpu_torch.data.synthetic import generate_synthetic_vid
    from dcnet_tpu_torch.models.darknet import random_darknet_weights_file
    from dcnet_tpu_torch.parallel import mesh
    from dcnet_tpu_torch.train.loop import flatten_clip_batch, to_device

    cfg = full_width_config()
    model, defs, setup_s = seeded_model(cfg, dev)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    batch = to_device(flatten_clip_batch(synthetic_clips(
        np.random.RandomState(9), DDP_CLIPS, 2, cfg.image_size, cfg.query_len)), dev)
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    real_neg = correspondence._sample_negatives_excluding
    work = tempfile.mkdtemp(prefix="dcnet_ddp_")
    cwd = os.getcwd()
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        correspondence._sample_negatives_excluding = _deterministic_negatives
        every = slice(None)
        plain = _dp_step(cfg, weights, batch, dev, every, ddp=False)
        mesh.init_distributed(dev)          # a NCCL group of one
        try:
            size, rank = mesh.world()
            backend = torch.distributed.get_backend()
            ddp = _dp_step(cfg, weights, batch, dev, every, ddp=True)
        finally:
            mesh.shutdown()
        correspondence._sample_negatives_excluding = real_neg
        diff = {k: (got[k].double() - v.double()).abs().max().item()
                for got, want in ((ddp[1], plain[1]), (ddp[2], plain[2]))
                for k, v in want.items()}
        step = {"clips": DDP_CLIPS, "world_size": size, "backend": backend,
                "metrics": ddp[0], "plain_metrics": plain[0],
                "metrics_equal": ddp[0] == plain[0],
                "max_abs_diff_grads_and_stats": max(diff.values()),
                "tensors_differing": sum(d > 0 for d in diff.values()),
                "launches": ddp[3], "plain_launches": plain[3]}
        if not step["metrics_equal"] or step["max_abs_diff_grads_and_stats"] != 0.0 \
                or launches_differ(ddp[3], plain[3]) or not ddp[3]["coattn_pair"]:
            raise AssertionError(f"the DDP step differs from the plain step: {step}")

        # cli/train.py --devices 1 against the plain run
        os.chdir(work)
        root = os.path.join(work, "synthetic")
        generate_synthetic_vid(root, "train", num_videos=TCLI_VIDEOS,
                               frames_per_video=TCLI_FRAMES, seed=13, frame_format="npy")
        generate_synthetic_vid(root, "test", num_videos=2, frames_per_video=TCLI_FRAMES,
                               seed=14, frame_format="npy")
        darknet = os.path.join(work, "backbone_seed0.weights")
        random_darknet_weights_file(defs, darknet, seed=0)
        argv = ["--synthetic", "--lstm"] + CLI_WIDTH + [
            "--batch_size", str(TCLI_BATCH), "--max_steps", str(TCLI_STEPS),
            "--nb_epoch", "1", "--workers", "4", "--seed", "13", "--split_root", work,
            "--backbone_weights", darknet, "--print_freq", "100"]
        ends, cli = {}, {}
        for name, extra in (("plain", []), ("devices_1", ["--devices", "1"]),
                            ("plain_again", [])):
            kernels.reset_launches()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                state = cli_train.main(argv + extra + ["--savename", name])
            torch.cuda.synchronize()
            cli[name] = {"s": time.perf_counter() - t0, "launches": dict(kernels.LAUNCHES),
                         "ddp": state.ddp is not None,
                         "checkpoints": sorted(os.listdir(os.path.join("saved_models",
                                                                       name)))}
            ends[name] = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
            del state

        def spread(a, b):
            return max((ends[a][k].double() - ends[b][k].double()).abs().max().item()
                       for k in ends[a] if ends[a][k].is_floating_point())

        cli_rec = {"runs": cli, "devices_1_vs_plain": spread("devices_1", "plain"),
                   "plain_vs_plain": spread("plain_again", "plain"),
                   "limit": f"{RESUME_SPREAD} x plain_vs_plain"}
        cli_rec["bitwise"] = cli_rec["devices_1_vs_plain"] == 0.0
        if not cli["devices_1"]["ddp"] or cli["plain"]["ddp"] or \
                cli_rec["devices_1_vs_plain"] > RESUME_SPREAD * cli_rec["plain_vs_plain"] or \
                launches_differ(cli["devices_1"]["launches"], cli["plain"]["launches"]):
            raise AssertionError(f"cli.train --devices 1 against the plain run: {cli_rec}")
        os.chdir(cwd)
        correspondence._sample_negatives_excluding = _deterministic_negatives
        two = two_process_step(cfg, weights, batch, dev, work)
    finally:
        torch.use_deterministic_algorithms(False)
        correspondence._sample_negatives_excluding = real_neg
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    kernels.reset_launches()
    launches = {k: step["launches"][k] + cli["devices_1"]["launches"][k]
                + two["launches"][k] for k in kernels.LAUNCHES}
    rec = {"phase": "ddp", "setup_s": setup_s, "train_step": step, "train_cli": cli_rec,
           "two_process_step": two, "launches": launches,
           "cards": torch.cuda.device_count(),
           "not_run": "two or more cards (NCCL across cards): this machine has one; two "
                      "processes ran on the one card over gloo (two_process_step), and on "
                      "the CPU in tests/test_torch_parallel.py",
           "kind": torch.cuda.get_device_name(dev), "nvidia_smi": nvidia_smi()}
    emit(rec)
    return rec


# --- the 2-D (data, model) mesh --------------------------------------------

MESH_P = MAIN_P                   # the windows' frames: the three scales at 256 px
MESH_STREAMS, MESH_TICKS, MESH_SAVE = 8, 8, 4      # the two-rank engine
MESH_TOL = dict(rtol=1e-4, atol=1e-4)              # mesh engine against one process
MESH_PACE_WARMUP, MESH_PACE_TICKS = 2, 6           # the 120-stream multiref ticks
MESH_EVAL_CLIPS = 2


def mesh_windows(p: int) -> list:
    """The row windows held on a P-row frame: P/2 and P/4 at offset 0 and
    at the last window, and a ragged one (37 rows at offset 11)."""
    return [(0, p // 2), (p - p // 2, p // 2), (0, p // 4), (p - p // 4, p // 4), (11, 37)]


def mesh_partitions(p: int) -> list:
    """Partitions of P rows into windows, whose K3 partial dkv sum to the
    whole frame's: halves, quarters, and ragged thirds."""
    return [[(0, p // 2), (p // 2, p - p // 2)],
            [(i * (p // 4), p // 4) for i in range(3)] + [(3 * (p // 4), p - 3 * (p // 4))],
            [(0, 11), (11, 37), (48, p - 48)]]


def _shifted(p: int, r0: int, rows: int) -> int:
    """The offset of the window moved by one row (down, or up at the end)."""
    return r0 + 1 if r0 + rows < p else r0 - 1


def _k3_window_held(got, q, kv, g, r0: int, dtype):
    """K3 on the window (r0, rows of g): dq and the partial dkv against
    the window's reference (fp32: float64 at K3_F64_TOL; bf16: the plain
    version at BWD_TOL), and whether the limits reject the window shifted
    by one row (its dq). Returns (ok, max err, rejects)."""
    rows = g.shape[1]
    s0 = _shifted(q.shape[1], r0, rows)
    if dtype == torch.float32:
        want, terms = k3_exact(q[:, r0:r0 + rows], kv, TEMPERATURE, g)
        res = [k3_agreement(a, w, m) for a, w, m in zip(got, want, terms)]
        shifted, _ = k3_exact(q[:, s0:s0 + rows], kv, TEMPERATURE, g)
        rej = not k3_agreement(got[0], shifted[0], terms[0])[0]
        return all(r[0] for r in res), max(r[1] for r in res), rej
    want = k_coattn.attend_bwd_plain(q, kv, TEMPERATURE, g, r0)
    shifted = k_coattn.attend_bwd_plain(q, kv, TEMPERATURE, g, s0)
    res = [agreement(a, w, dtype, BWD_TOL) for a, w in zip(got, want)]
    rej = not agreement(got[0], shifted[0], dtype, BWD_TOL)[0]
    return all(r[0] for r in res), max(r[1] for r in res), rej


def mesh_window_cases(dev, gen) -> list:
    """K1 (B=8), K2 and K3 (B=16) on row windows at P in MESH_P, C=512, fp32
    and bf16: each window against its plain version (K3: fp32 against
    float64), against the rows of the full launch (bitwise predicted for K1
    and K2), a window shifted by one row rejected by the limits, K3's
    partial dkv over each partition summed against the whole frame's
    reference and the full launch's dkv, and the device ms of the P/2 and
    P/4 launches beside the full one."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for p in MESH_P:
            q = _rows(gen, KERNEL_B, p, KERNEL_C).to(dev, dtype)
            kv = _rows(gen, KERNEL_B, p, KERNEL_C).to(dev, dtype)
            clip = _rows(gen, TRAIN_B, 2, p, KERNEL_C).to(dev, dtype)
            f1, f2 = clip[:, 0], clip[:, 1]
            g = torch.randn(TRAIN_B, p, KERNEL_C, generator=gen).to(dev, dtype)
            with torch.no_grad():
                full1 = k_coattn.attend_window(q, kv, TEMPERATURE, 0, p)
                full2 = k_coattn.attend_pair_window(f1, f2, TEMPERATURE, 0, p)
            full3 = k_coattn.attend_bwd(f1, f2, TEMPERATURE, g)
            rec = {"phase": "mesh", "what": "windows", "dtype": str(dtype)[6:], "P": p,
                   "C": KERNEL_C, "B": {"K1": KERNEL_B, "K2": TRAIN_B, "K3": TRAIN_B},
                   "windows": {}}
            ok = True
            for r0, rows in mesh_windows(p):
                s0 = _shifted(p, r0, rows)
                with torch.no_grad():
                    o1 = k_coattn.attend_window(q, kv, TEMPERATURE, r0, rows)
                    o2 = k_coattn.attend_pair_window(f1, f2, TEMPERATURE, r0, rows)
                w1 = k_coattn.attend_plain(q, kv, TEMPERATURE, r0, rows)
                w2 = (k_coattn.attend_plain(f1, f2, TEMPERATURE, r0, rows),
                      k_coattn.attend_plain(f2, f1, TEMPERATURE, r0, rows))
                torch.cuda.synchronize()
                a1 = agreement(o1, w1, dtype)
                a2 = [agreement(x, w, dtype) for x, w in zip(o2, w2)]
                rej = (not agreement(o1, k_coattn.attend_plain(q, kv, TEMPERATURE, s0,
                                                               rows), dtype)[0]
                       and not agreement(o2[0], k_coattn.attend_plain(
                           f1, f2, TEMPERATURE, s0, rows), dtype)[0])
                eq1 = torch.equal(o1, full1[:, r0:r0 + rows])
                eq2 = all(torch.equal(x, f[:, r0:r0 + rows]) for x, f in zip(o2, full2))
                rec["windows"][f"{r0}+{rows}"] = {
                    "K1_max_abs_err": a1[1], "K2_max_abs_err": max(a[1] for a in a2),
                    "K1_equal_to_full_rows": eq1, "K2_equal_to_full_rows": eq2,
                    "shift_by_one_rejected": rej}
                ok = ok and a1[0] and all(a[0] for a in a2) and rej
            if dtype == torch.float32:
                want3, terms3 = k3_exact(f1, f2, TEMPERATURE, g)
            else:
                want3 = k_coattn.attend_bwd_plain(f1, f2, TEMPERATURE, g)
            for partition in mesh_partitions(p):
                parts = []
                total, worst, rej_all, dq_eq = None, 0.0, True, True
                for r0, rows in partition:
                    gw = g[:, r0:r0 + rows].contiguous()
                    got = k_coattn.attend_bwd(f1, f2, TEMPERATURE, gw, row0=r0)
                    w_ok, err, rej = _k3_window_held(got, f1, f2, gw, r0, dtype)
                    ok = ok and w_ok and rej
                    worst, rej_all = max(worst, err), rej_all and rej
                    dq_eq = dq_eq and torch.equal(got[0], full3[0][:, r0:r0 + rows])
                    part = got[1].float()
                    total = part if total is None else total + part
                    parts.append(got[1])
                if dtype == torch.float32:
                    sum_ok, sum_err, _, _ = k3_agreement(total, want3[1], terms3[1])
                else:
                    sum_ok, sum_err, _ = agreement(total, want3[1], dtype, BWD_TOL,
                                                   terms=parts)
                ok = ok and sum_ok
                rec["windows"]["K3 " + ",".join(f"{a}+{b}" for a, b in partition)] = {
                    "K3_max_abs_err": worst, "shift_by_one_rejected": rej_all,
                    "K3_dq_equal_to_full_rows": dq_eq,
                    "dkv_sum_max_abs_err": sum_err, "dkv_sum_within_limits": sum_ok,
                    "dkv_sum_vs_full_launch_max_abs_diff":
                        (total - full3[1].float()).abs().max().item()}
            iters = 20 if p >= 1024 else 50
            rec["ms"] = {}
            for label, rows in (("full", p), ("half", p // 2), ("quarter", p // 4)):
                gw = g[:, :rows].contiguous()
                with torch.no_grad():
                    rec["ms"][label] = {
                        "K1": device_ms(lambda: k_coattn.attend_window(
                            q, kv, TEMPERATURE, 0, rows), iters),
                        "K2": device_ms(lambda: k_coattn.attend_pair_window(
                            f1, f2, TEMPERATURE, 0, rows), iters // 2),
                        "K3": device_ms(lambda: k_coattn.attend_bwd(
                            f1, f2, TEMPERATURE, gw, row0=0), max(iters // 4, 3))}
            rec["ok"] = ok
            emit(rec)
            if not ok:
                raise AssertionError(f"a row window disagrees: {rec}")
            cases.append(rec)
    return cases


def _mesh_group_of_one(cfg, weights, batch, evals, dev) -> dict:
    """A NCCL group of one with tp_internals on a (1, 1) mesh: the train
    step through DDP and eval_clip against the plain ones, bitwise, with
    the same launches."""
    from dcnet_tpu_torch.parallel import mesh

    tp = cfg.replace(tp_internals=True)
    images, ids = evals["images"], evals["ids"]

    def eval_once(c):
        from dcnet_tpu_torch.models.dcnet import DCNet
        model = DCNet(c, backbone_defs=_defs(), device=dev)
        model.load_state_dict(weights)
        kernels.reset_launches()
        out = model.eval_clip(images, ids)
        torch.cuda.synchronize()
        return [o.detach() for o in out.outbox], dict(kernels.LAUNCHES)

    plain = _dp_step(cfg, weights, batch, dev, slice(None), ddp=False)
    plain_eval = eval_once(cfg)
    mesh.init_distributed(dev)
    try:
        mesh.make_mesh(1, 1)
        one = _dp_step(tp, weights, batch, dev, slice(None), ddp=True)
        one_eval = eval_once(tp)
        backend = torch.distributed.get_backend()
    finally:
        mesh.shutdown()
    rec = {"backend": backend, "mesh": [1, 1], "tp_internals": True,
           "step_metrics_equal": one[0] == plain[0],
           "step_tensors_differing": sum(not torch.equal(a, want[k])
                                         for got, want in ((one[1], plain[1]),
                                                           (one[2], plain[2]))
                                         for k, a in got.items()),
           "eval_equal": all(torch.equal(a, b) for a, b in zip(one_eval[0], plain_eval[0])),
           "step_launches": one[3], "eval_launches": one_eval[1]}
    if not (rec["step_metrics_equal"] and rec["step_tensors_differing"] == 0
            and rec["eval_equal"] and not launches_differ(one[3], plain[3])
            and not launches_differ(one_eval[1], plain_eval[1])
            and one[3]["coattn_pair"] == 3 and one[3]["coattn_attend_bwd"] == 6
            and one_eval[1]["coattn_attend"] == 12):
        raise AssertionError(f"tp_internals in a group of one differs from the plain "
                             f"path: {rec}")
    return rec


def _mesh_serve(eng, ids, frames, ticks: int, start: int = 0, state=None, save=None,
                m=None):
    """Ticks start..ticks-1 of the engine (the state saved before MESH_SAVE
    to `save`): (state, [(fused, raw, score) on the host] per tick,
    launches of the run)."""
    from dcnet_tpu_torch.serving import engine as pengine
    state = eng.init_state(ids) if state is None else state
    outs = []
    kernels.reset_launches()
    for t in range(start, ticks):
        if t == MESH_SAVE and save:
            pengine.save_stream_state(save, state, mesh=m)
        state, fused, raw, score = eng.step(state, frames[t])
        outs.append([x.float().cpu() for x in (fused, raw, score)])
    torch.cuda.synchronize()
    return state, outs, dict(kernels.LAUNCHES)


def _mesh_pace(model, ids, frames, m=None) -> dict:
    """s/tick of the serving cell's bf16 multiref engine (120 streams;
    with a mesh this rank's share of them)."""
    from dcnet_tpu_torch.serving.engine import GroundingEngine
    eng = GroundingEngine(model, SERVE_STREAMS, mesh=m)
    state = eng.init_state(ids)
    for t in range(MESH_PACE_WARMUP):
        state = eng.step(state, frames[t % len(frames)])[0]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for t in range(MESH_PACE_TICKS):
        state = eng.step(state, frames[t % len(frames)])[0]
    torch.cuda.synchronize()
    return {"streams": SERVE_STREAMS, "local_streams": eng.shard.stop - eng.shard.start,
            "s_per_tick": (time.perf_counter() - t0) / MESH_PACE_TICKS,
            "ticks": MESH_PACE_TICKS, "launches": dict(kernels.LAUNCHES)}


def _mesh_inputs(cfg) -> dict:
    """The two-rank work's seeded inputs: streams and phrases of the fp32
    engine and of the bf16 multiref cell."""
    rng = np.random.RandomState(31)
    return {"frames": torch.from_numpy(rng.rand(MESH_TICKS, MESH_STREAMS, cfg.image_size,
                                                cfg.image_size, 3).astype(np.float32)),
            "ids": _phrases(rng, cfg, MESH_STREAMS),
            "pace_frames": torch.from_numpy(rng.rand(2, SERVE_STREAMS, cfg.image_size,
                                                     cfg.image_size, 3).astype(np.float32)),
            "pace_ids": _phrases(rng, cfg, SERVE_STREAMS)}


def _mesh_pair_work(inputs, dev, work: str) -> dict:
    """One rank's work in the two-rank mesh phase (this process joined to
    the gloo group of 2): the (data 1, model 2) fp32 k=2 train step with
    tp_internals and an eval_clip under it; the (data 2, model 1) engine at
    MESH_STREAMS fp32 streams, its state saved before MESH_SAVE; the bf16
    multiref cell's ticks at 120 streams."""
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.parallel import mesh
    from dcnet_tpu_torch.serving.engine import GroundingEngine, cast_params_for_serving

    cfg, weights, batch = inputs["cfg"], inputs["weights"], inputs["batch"]
    mesh.make_mesh(1, 2)
    tp = cfg.replace(tp_internals=True)
    step = _dp_step(tp, weights, batch, dev, slice(None), ddp=True)
    model = DCNet(tp, backbone_defs=_defs(), device=dev)
    model.load_state_dict(weights)
    kernels.reset_launches()
    out = model.eval_clip(inputs["evals"]["images"], inputs["evals"]["ids"])
    torch.cuda.synchronize()
    res = {"step_metrics": step[0], "step_stats": {k: v.cpu() for k, v in step[2].items()},
           "step_launches": step[3], "eval_launches": dict(kernels.LAUNCHES),
           "eval": [o.detach().cpu() for o in out.outbox], "grads": step[1]}
    mesh.clear_mesh()
    m = mesh.make_mesh(2, 1)     # no model axis: the engine runs unsharded rows
    eng = GroundingEngine(model, MESH_STREAMS, topk=3, fuse_window=3, mesh=m,
                          donate_state=False)
    _, res["engine"], res["engine_launches"] = _mesh_serve(
        eng, inputs["ids"], inputs["frames"], MESH_TICKS,
        save=os.path.join(work, "mesh_state.npz"), m=m)
    bf = DCNet(serving_config(compute_dtype="bfloat16", coattn_multiref=True),
               backbone_defs=_defs(), device=dev)
    bf.load_state_dict(weights)
    cast_params_for_serving(bf)
    res["pace"] = _mesh_pace(bf, inputs["pace_ids"], inputs["pace_frames"], m)
    return res


def _mesh_rank(i: int, init: str, work: str) -> None:
    """Rank i + 1 of the two-rank mesh phase (spawned, on the same card)."""
    import torch.distributed as dist
    from dcnet_tpu_torch.parallel import mesh

    rank = i + 1
    inputs = torch.load(os.path.join(work, "mesh_inputs.pt"), weights_only=False)
    dev = torch.device(inputs["device"])
    torch.cuda.set_device(dev)
    _dp_flags()
    correspondence._sample_negatives_excluding = _deterministic_negatives
    dist.init_process_group("gloo", init_method=init, world_size=DDP_RANKS, rank=rank)
    try:
        res = _mesh_pair_work(inputs, dev, work)
        del res["grads"]       # rank 0's, which DDP and the model group make equal
        torch.save(res, os.path.join(work, f"mesh_rank{rank}.pt"))
    finally:
        mesh.shutdown()


def _outs_close(got: list, want: list) -> tuple:
    """(within MESH_TOL at every tick, the largest difference)."""
    ok, worst = True, 0.0
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            ok = ok and x.shape == y.shape and bool(torch.allclose(x, y, **MESH_TOL))
            worst = max(worst, (x - y).abs().max().item())
    return ok and len(got) == len(want), worst


def _mesh_two_ranks(cfg, weights, batch, evals, dev, work: str) -> dict:
    """Two processes on the one card joined by gloo over CUDA tensors: the
    (data 1, model 2) TP step held against the one-process step by
    train_parity's rule (each module's gradient within max(1e-3, 2 d), d
    the distance between two fp32 evaluations of the one-process step; the
    JAX data-parallel limits on the metrics; running statistics within
    DP_STATS_RTOL and equal on both ranks), K2 3 and K3 6 on windows on
    each rank, eval_clip under it (K1 12 on windows) against the
    one-process eval_clip; the (data 2, model 1) engine against the
    one-process engine within MESH_TOL every tick, the pair's state file
    resumed in one process; the bf16 multiref cell's s/tick per rank beside
    the one-process engine's (two processes on one card measure no
    scaling)."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.parallel import mesh
    from dcnet_tpu_torch.serving import engine as pengine

    cfg = cfg.replace(jemb_dropout=0.0, input_dropout=0.0)
    inputs = {"cfg": cfg, "weights": weights, "batch": batch, "evals": evals,
              "device": str(dev), **_mesh_inputs(cfg)}
    torch.save(inputs, os.path.join(work, "mesh_inputs.pt"))
    init = "file://" + os.path.join(work, "mesh_store")
    t0 = time.perf_counter()
    ctx = mp.start_processes(_mesh_rank, args=(init, work), nprocs=DDP_RANKS - 1,
                             join=False, start_method="spawn")
    try:
        # the one-process references while the second process starts
        one = _dp_step(cfg, weights, batch, dev, slice(None), ddp=False)
        summed = _dp_step(cfg, weights, batch, dev, slice(None), False, "summed")
        model = DCNet(cfg, backbone_defs=_defs(), device=dev)
        model.load_state_dict(weights)
        one_eval = [o.detach().cpu() for o in model.eval_clip(
            evals["images"], evals["ids"]).outbox]
        plain = pengine.GroundingEngine(model, MESH_STREAMS, topk=3, fuse_window=3,
                                        donate_state=False)
        _, want, _ = _mesh_serve(plain, inputs["ids"], inputs["frames"], MESH_TICKS)
        bf = DCNet(serving_config(compute_dtype="bfloat16", coattn_multiref=True),
                   backbone_defs=_defs(), device=dev)
        bf.load_state_dict(weights)
        pengine.cast_params_for_serving(bf)
        one_pace = _mesh_pace(bf, inputs["pace_ids"], inputs["pace_frames"])
        dist.init_process_group("gloo", init_method=init, world_size=DDP_RANKS, rank=0)
        try:
            mine = _mesh_pair_work(inputs, dev, work)
        finally:
            mesh.shutdown()
    except BaseException:
        for proc in ctx.processes:  # they would wait on rank 0's collectives
            proc.terminate()
        raise
    while not ctx.join():
        pass
    ranks = [mine] + [torch.load(os.path.join(work, f"mesh_rank{r}.pt"), weights_only=False)
                      for r in range(1, DDP_RANKS)]
    state = pengine.load_stream_state(os.path.join(work, "mesh_state.npz"), dev)
    _, resumed, _ = _mesh_serve(plain, inputs["ids"], inputs["frames"], MESH_TICKS,
                                start=MESH_SAVE, state=state)
    noise = _module_distances(summed[1], one[1])
    limit = {k: max(DP_GRAD_FLOOR, 2 * d) for k, d in noise.items()}
    dist_m = _module_distances(mine["grads"], one[1])
    step = {
        "mesh": [1, 2], "metrics": [r["step_metrics"] for r in ranks],
        "one_process_metrics": one[0],
        "within_jax_limits": all(_dp_within(r["step_metrics"], one[0]) for r in ranks),
        "grad_rel_l2": dist_m, "limits": limit,
        "modules_beyond_limit": sorted(k for k, d in dist_m.items() if d > limit[k]),
        "stats_equal_on_every_rank": all(
            torch.equal(r["step_stats"][k], v) for r in ranks[1:]
            for k, v in ranks[0]["step_stats"].items()),
        "stats_excess_over_rtol": max(
            ((v.double() - one[2][k].cpu().double()).abs()
             - DP_STATS_RTOL * one[2][k].cpu().double().abs()).max().item()
            for k, v in ranks[0]["step_stats"].items()),
        "launches_per_rank": [r["step_launches"] for r in ranks]}
    eval_err = max((a - b).abs().max().item() for r in ranks
                   for a, b in zip(r["eval"], one_eval))
    eng = [_outs_close(r["engine"], want) for r in ranks]
    res_ok, res_err = _outs_close(resumed, want[MESH_SAVE:])
    rec = {"ranks": DDP_RANKS, "backend": "gloo (CUDA tensors, one card)",
           "train_step": step,
           "eval_clip": {"clips": MESH_EVAL_CLIPS, "max_abs_diff": eval_err,
                         "launches_per_rank": [r["eval_launches"] for r in ranks]},
           "engine": {"streams": MESH_STREAMS, "ticks": MESH_TICKS, "mesh": [2, 1],
                      "within_tol": [e[0] for e in eng], "max_abs_diff": [e[1] for e in eng],
                      "tol": MESH_TOL, "launches_per_rank": [r["engine_launches"]
                                                             for r in ranks],
                      "resumed_in_one_process": {"within_tol": res_ok,
                                                 "max_abs_diff": res_err}},
           "pace_bf16_multiref": {"one_process": one_pace,
                                  "per_rank": [r["pace"] for r in ranks],
                                  "note": "two processes share one card: no scaling is "
                                          "measured"},
           "seconds": time.perf_counter() - t0}
    windows = all(r["step_launches"]["coattn_pair"] == 3
                  and r["step_launches"]["coattn_attend_bwd"] == 6
                  and r["eval_launches"]["coattn_attend"] == 12 for r in ranks)
    if not (step["within_jax_limits"] and not step["modules_beyond_limit"]
            and step["stats_equal_on_every_rank"]
            and step["stats_excess_over_rtol"] <= DP_STATS_ATOL and windows
            and eval_err <= 1e-3 and all(e[0] for e in eng) and res_ok):
        raise AssertionError(f"the two-rank mesh misses the one-process runs: {rec}")
    return rec


def phase_mesh(dev) -> dict:
    """The 2-D (data, model) mesh on one card: K1, K2 and K3 on row windows
    (`mesh_window_cases`); a NCCL group of one with tp_internals, bitwise
    the plain step and eval_clip (`_mesh_group_of_one`); two gloo ranks on
    the card (`_mesh_two_ranks`); `dryrun_multichip(4)` on the card (4
    gloo ranks, a 2 x 2 mesh, the mini model at 64 px). Two or more cards
    (NCCL across cards) cannot run on a one-card machine: the phase says
    so."""
    import shutil
    import tempfile
    from dcnet_tpu_torch.dryrun import dryrun_multichip
    from dcnet_tpu_torch.train.loop import flatten_clip_batch, to_device

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(14)
    windows = mesh_window_cases(dev, gen)
    t_windows = time.perf_counter() - t0
    cfg = full_width_config()
    model, _, setup_s = seeded_model(cfg, dev)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    batch = to_device(flatten_clip_batch(synthetic_clips(
        np.random.RandomState(9), DDP_CLIPS, 2, cfg.image_size, cfg.query_len)), dev)
    clips = to_device(flatten_clip_batch(synthetic_clips(
        np.random.RandomState(10), MESH_EVAL_CLIPS, 5, cfg.image_size, cfg.query_len)),
        dev)
    evals = {"images": clips["images"], "ids": clips["word_ids"][::5]}
    real_neg = correspondence._sample_negatives_excluding
    before = _dp_flags()
    work = tempfile.mkdtemp(prefix="dcnet_mesh_")
    try:
        correspondence._sample_negatives_excluding = _deterministic_negatives
        torch.use_deterministic_algorithms(True, warn_only=True)
        one = _mesh_group_of_one(cfg, weights, batch, evals, dev)
        t1 = time.perf_counter()
        two = _mesh_two_ranks(cfg, weights, batch, evals, dev, work)
        t2 = time.perf_counter()
    finally:
        torch.use_deterministic_algorithms(False)
        correspondence._sample_negatives_excluding = real_neg
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = before
        shutil.rmtree(work, ignore_errors=True)
    kernels.reset_launches()
    lines = dryrun_multichip(4, device="cuda")
    t3 = time.perf_counter()
    if len(lines) != 3 or not all(x.endswith(" ok") for x in lines):
        raise AssertionError(f"dryrun_multichip(4) on the card: {lines}")
    # rank 0's launches on the mesh paths: the TP step and eval_clip, the
    # mesh engine's ticks and the multiref cell's timed ticks
    launches = {k: two["train_step"]["launches_per_rank"][0][k]
                + two["eval_clip"]["launches_per_rank"][0][k]
                + two["engine"]["launches_per_rank"][0][k]
                + two["pace_bf16_multiref"]["per_rank"][0]["launches"][k]
                for k in kernels.LAUNCHES}
    rec = {"phase": "mesh", "setup_s": setup_s, "group_of_one": one, "two_ranks": two,
           "dryrun_multichip_4": lines, "launches": launches,
           "seconds": {"windows": t_windows, "group_of_one": t1 - t0 - t_windows - setup_s,
                       "two_ranks": t2 - t1, "dryrun": t3 - t2},
           "cards": torch.cuda.device_count(),
           "not_run": "two or more cards (NCCL across cards): this machine has one; the "
                      "ranks ran on the one card over gloo, and on the CPU in "
                      "tests/test_torch_mesh.py",
           "kind": torch.cuda.get_device_name(dev), "nvidia_smi": nvidia_smi()}
    emit(rec)
    return {"launches": launches, "windows": windows, **rec}


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
    ("conv_s8", "int8_eval", "dcnet_tpu_torch/csrc/conv_s8_tma.cuh",
     "none: no TPU kernel; the JAX package's int8 conv is XLA's "
     "lax.conv_general_dilated(int8, int8, preferred_element_type=int32), "
     "dcnet_tpu/ops/quant.py:224-227 and dcnet_tpu/models/heads.py:93-96, :121-132"),
    ("conv_s8_halo", "int8_eval", "dcnet_tpu_torch/csrc/conv_s8_halo.cuh",
     "none: no TPU kernel; K6's route for thin reductions, the JAX package's "
     "int8 conv is XLA's, dcnet_tpu/ops/quant.py:224-236"),
    ("conv_s8_gather", None, "dcnet_tpu_torch/csrc/conv_s8.cuh",
     "none: no TPU kernel; K6's route for the shapes the TMA and halo routes "
     "cannot map (no path's), the JAX package's int8 conv is XLA's, "
     "dcnet_tpu/ops/quant.py:224-236"),
    ("conv_s8_quant", "int8_eval", "dcnet_tpu_torch/csrc/conv_s8.cuh",
     "none: no TPU kernel; the JAX package's quantize step is XLA's "
     "clip(round(x * inv), -127, 127).astype(int8), dcnet_tpu/ops/quant.py:229 "
     "and dcnet_tpu/models/heads.py:121-132"),
)


def _headline(name: str, case: dict) -> bool:
    """The case a kernel's entry reports: K1-K4 at P=1024, C=512, bf16 (B=8
    for K1's eval request, B=16 for the train step's K2 and K3, B=120
    streams for K4); K5 at B=8, P=1344, fp32 ce (the fp32 eval trunk's);
    K6's TMA route and quantize pass at K6_HEADLINE, its halo and gather
    routes at K6_HALO_HEADLINE, on 8 frames, bf16 out."""
    if name == "loc_gram":
        return (case["B"] == 8 and case["P"] == LOC_P and case["E"] == LOC_E
                and case["C"] == KERNEL_C and case["dtype"] == "float32")
    if name in ("conv_s8_halo", "conv_s8_gather"):
        return (case["k"], case["stride"], case["Ci"], case["Co"], case["side"]) == \
            K6_HALO_HEADLINE
    if name in ("conv_s8", "conv_s8_quant"):
        return (case["group"] == "backbone" and (case["k"], case["stride"], 1, case["Ci"],
                                                 case["Co"], case["side"]) == K6_HEADLINE)
    return (case["P"] == max(MAIN_P) and case["C"] == KERNEL_C
            and case["dtype"] == "bfloat16")


def kernels_line(cases: list, launches: dict, by_path=None) -> dict:
    """One entry per kernel: headline numbers (`_headline`), every case
    under `cases`. `launches` are the counts of the path each kernel runs
    on (eval for K1, train for K2 and K3, serving for K4, the int8 eval
    for K6); K5 and K6's gather route run on no path (`"path": null`) and
    report their kernel-phase launches.
    `by_path` adds, per kernel, its counts on every path that runs it (K1:
    eval and the CLIs), each path driven with the counts at 0. Each
    entry's "timer" names what its "ms", "plain_ms" and "library_ms"
    measure (`TIMERS`)."""
    out = []
    for name, path, source, replaces in KERNELS:
        mine = [c for c in cases if c["name"] == name]
        head = next(c for c in mine if _headline(name, c))
        worst = max(c["max_abs_err"] for c in mine
                    if c["dtype"] == head["dtype"] and (c["C"] == head["C"]
                                                        or name.startswith("conv_s8")))
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "path": path, "launches": launches[name],
            "launches_by_path": (by_path or {}).get(
                name, {path: launches[name]} if path else {}),
            "shape": {k: head[k] for k in ("B", "P", "C", "k", "stride", "Ci", "Co",
                                           "side", "dtype") if k in head},
            "max_abs_err": worst, "timer": head["timer"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "bodies": sorted({c["body"] for c in mine if c.get("body")}),
            "cases": [{k: c.get(k) for k in (
                ("group", "k", "stride", "Ci", "Co", "side", "plan", "max_abs_err", "ms",
                 "int32_ms", "gather_ms", "gather_int32_ms", "plain_ms", "library_ms",
                 "cudnn_bf16_conv_ms", "bound_ms",
                 "int32_bound_ms", "bound_by", f"at_{K6_FRAMES}", f"at_{K6_TICK_FRAMES}")
                if name in ("conv_s8", "conv_s8_halo", "conv_s8_gather")
                else ("group", "k", "stride", "Ci", "Co", "side", "cp", "max_abs_err", "ms",
                      "plain_ms", "bound_ms", f"at_{K6_TICK_FRAMES}")
                if name == "conv_s8_quant" else
                ("dtype", "B", "P", "C", "E", "body", "max_abs_err", "rel_err", "ms",
                 "call_ms", "plain_ms", "library_ms", "rank8_route_ms", "bound_ms",
                 "bound_by", "library_backends"))}
                      for c in mine]})
    return {"kernels": out, "timers": TIMERS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default="",
                    help="directory for torch.profiler tables of one "
                         "eval_clip and one train_step per dtype and one "
                         "serving tick per mode")
    ap.add_argument("--cli-pace", action="store_true",
                    help="only time the eval CLI over longer splits, by "
                         "decode path (after the device and build phases)")
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run after the device and "
                         "build phases (e.g. export,serve_cli,ddp), without the "
                         "kernels line: a quick check of those phases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    seconds = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = round(time.perf_counter() - t0, 3)
        return out

    info = timed("device", phase_device, dev)
    k6_build = timed("build", phase_build)
    if args.cli_pace:
        finish_k6_build(k6_build)
        phase_cli_pace(dev)
        return 0
    if args.only:
        finish_k6_build(k6_build)
        for name in args.only.split(","):
            timed(name, globals()[f"phase_{name}"], dev)
        emit({"phase": "seconds", **seconds})
        return 0
    cases, off_path = timed("kernel", phase_kernel, dev, k6_build)
    prof = dict(profile_dir=args.profile)
    slice_rec = timed("slice", phase_slice, dev, **prof)
    eval_launches = slice_rec["launches"]
    int8_launches = timed("int8", phase_int8, dev, **prof)["launches"]
    train_rec = timed("train", phase_train, dev, **prof)
    train_launches = train_rec["launches"]
    bert = timed("bert", phase_bert, dev, slice_rec["timing"], train_rec["timing"])
    serving_launches = timed("serving", phase_serving, dev, **prof)["launches"]
    serving_int8 = timed("serving_int8", phase_serving_int8, dev, **prof)["launches"]
    cli_launches = timed("cli", phase_cli, dev)["launches"]
    native_launches = timed("native", phase_native, dev)["launches"]
    train_cli = timed("train_cli", phase_train_cli, dev)["launches"]
    exported = timed("export", phase_export, dev)["variants"]
    serve_cli = timed("serve_cli", phase_serve_cli, dev)["launches"]
    ddp = timed("ddp", phase_ddp, dev)["launches"]
    mesh = timed("mesh", phase_mesh, dev)["launches"]
    emit({"phase": "seconds", **seconds})
    if PROFILE_FAILURES:
        raise AssertionError(f"profiles that lost kernels in every trace: {PROFILE_FAILURES}")
    if not (cli_launches["coattn_attend"] and native_launches["coattn_attend"]):
        raise AssertionError(f"K1 never launched on the CLI paths: {cli_launches}, "
                             f"{native_launches}")
    on_paths = {"coattn_attend": eval_launches["coattn_attend"],
                "coattn_pair": train_launches["coattn_pair"],
                "coattn_attend_bwd": train_launches["coattn_attend_bwd"],
                "coattn_ring": serving_launches["coattn_ring"],
                "conv_s8": int8_launches["conv_s8"],
                "conv_s8_halo": int8_launches["conv_s8_halo"],
                "conv_s8_quant": int8_launches["conv_s8_quant"]}
    if not all(on_paths.values()):
        raise AssertionError(f"a kernel of the paths never launched: {on_paths}")
    if not all(off_path.values()):
        raise AssertionError(f"a kernel of no path never launched in the kernel phase: "
                             f"{off_path}")
    launches = {**on_paths, **off_path}
    if not (bert["eval_launches"]["coattn_attend"] and all(train_cli.values())):
        raise AssertionError(f"a kernel never launched on the BERT or train CLI path: "
                             f"{bert['eval_launches']}, {train_cli}")
    runtime = {k: v["launches"] for k, v in exported.items()}
    if not (runtime["float"]["coattn_ring"] and runtime["k1"]["coattn_attend"]
            and runtime["quantized"]["coattn_ring"] and all(
                runtime["quantized"][k] for k in ("conv_s8", "conv_s8_halo", "conv_s8_quant"))
            and serve_cli["coattn_attend"] and serve_cli["conv_s8"]
            and ddp["coattn_pair"] and ddp["coattn_attend_bwd"]
            and all(mesh[k] for k in ("coattn_attend", "coattn_pair", "coattn_attend_bwd",
                                      "coattn_ring"))):
        raise AssertionError(f"a kernel never launched on the exported runtime, the serve "
                             f"CLI, the DDP or the mesh paths: {runtime}, {serve_cli}, "
                             f"{ddp}, {mesh}")
    emit(kernels_line(cases, launches, by_path={
        "coattn_attend": {"eval": eval_launches["coattn_attend"],
                          "bert_eval": bert["eval_launches"]["coattn_attend"],
                          "int8_eval": int8_launches["coattn_attend"],
                          "cli": cli_launches["coattn_attend"],
                          "cli_host_loader": native_launches["coattn_attend"],
                          "int8_serving_k1": serving_int8["k1"]["coattn_attend"],
                          "export_runtime_k1": runtime["k1"]["coattn_attend"],
                          "serve_cli": serve_cli["coattn_attend"],
                          "mesh": mesh["coattn_attend"]},
        **{name: {"train": train_launches[name],
                  "bert_train": bert["train_launches"][name],
                  "train_cli": train_cli[name], "ddp": ddp[name], "mesh": mesh[name]}
           for name in ("coattn_pair", "coattn_attend_bwd")},
        "coattn_ring": {"serving": serving_launches["coattn_ring"],
                        "int8_serving_multiref": serving_int8["multiref"]["coattn_ring"],
                        "export_runtime": runtime["float"]["coattn_ring"],
                        "export_runtime_quantized": runtime["quantized"]["coattn_ring"],
                        "mesh": mesh["coattn_ring"]},
        **{name: {"int8_eval": int8_launches[name],
                  **{f"int8_serving_{k}": v[name] for k, v in serving_int8.items()},
                  "int8_cli": cli_launches[name],
                  "export_runtime_quantized": runtime["quantized"][name],
                  "serve_cli": serve_cli[name]}
           for name in ("conv_s8", "conv_s8_halo", "conv_s8_quant")}}))
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
