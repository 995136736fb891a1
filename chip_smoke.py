"""Drives the PyTorch/CUDA port (`dcnet_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --profile DIR   # and torch.profiler tables of eval_clip

Phases, each printing one JSON line, any failure exiting non-zero:
  1. device  -- the card (nvidia-smi name and power limit), torch/CUDA
     versions; TF32 is switched off for matmuls and cuDNN convolutions.
  2. build   -- compiles every kernel from `dcnet_tpu_torch/csrc/` with nvcc.
  3. kernel  -- each kernel against its plain PyTorch version on the card at
     the main path's shapes (plus a ragged P), timed beside the plain
     version, one PyTorch library call and the card's bound.
  4. slice   -- the full-width 256 px model (YOLOv3 backbone from a seeded
     Darknet `.weights` file, the rest from a seeded torch.Generator)
     answers batches of 5-frame clips through eval_clip -> decode_best; the
     kernel launch counts of that run are checked (12 per eval_clip), the
     outputs are held against the same model run on the CPU, K1 is held
     against its plain version on the model's own mapped features in each
     compute dtype, and eval_clip is timed in float32 and bfloat16.
Then the `kernels` line, the nvidia-smi line, and as the last line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

try:
    import dcnet_tpu_torch  # noqa: F401
except ImportError as e:  # run outside a checkout of the repository
    sys.exit(f"chip_smoke: cannot import dcnet_tpu_torch ({e}); run it from "
             f"the root of a checkout")

from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.kernels import build
from dcnet_tpu_torch.kernels import coattn as k_coattn

# H100 SXM data-sheet peaks (dense), the card's memory rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TEMPERATURE = 10.0
KERNEL_B, KERNEL_C = 8, 512
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


def agreement(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype):
    """(ok, max |got - want|, ||got - want|| / ||want||) at dtype's limits."""
    g, w = got.float(), want.float()
    rel = ((g - w).norm() / w.norm()).item()
    ok = bool(torch.allclose(g, w, **TOL[dtype])) and rel <= REL_TOL[dtype]
    return ok, (g - w).abs().max().item(), rel


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events over `iters`."""
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


def attend_bound(b: int, p: int, c: int, dtype: torch.dtype):
    """Least time (ms) for one attend launch and what bounds it."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    t_ops = 4.0 * b * p * p * c / PEAK_FLOPS[dtype]
    t_bytes = 3.0 * b * p * c * itemsize / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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


def phase_build() -> None:
    t0 = time.perf_counter()
    build.build(["coattn"])
    k_coattn._lib()
    emit({"phase": "build", "kernels": ["coattn"],
          "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": {k: round(v, 3)
                           for k, v in build.BUILD_SECONDS.items()}})
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[nvcc {name}] {line.strip()}", flush=True)


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


def phase_kernel(dev) -> list:
    """K1 against its plain version on the card; returns the case records."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for p in MAIN_P + (RAGGED_P,):
            b, c = KERNEL_B, KERNEL_C
            # l2-normalized rows, like the mapped features on the main path
            q = torch.nn.functional.normalize(
                torch.randn(b, p, c, generator=gen), dim=-1).to(dev, dtype)
            kv = torch.nn.functional.normalize(
                torch.randn(b, p, c, generator=gen), dim=-1).to(dev, dtype)
            got = k_coattn.coattention_one(q, kv, TEMPERATURE)
            want = k_coattn.attend_plain(q, kv, TEMPERATURE)
            torch.cuda.synchronize()
            ok, err, rel = agreement(got, want, dtype)
            # the limits must reject a kernel that writes zeros or drops T
            rejects = not (agreement(torch.zeros_like(want), want, dtype)[0]
                           or agreement(k_coattn.attend_plain(q, kv, 1.0),
                                        want, dtype)[0])
            # a frame sliced out of a (B, 5, P, C) clip: batch-strided input
            clip = torch.nn.functional.normalize(
                torch.randn(b, 5, p, c, generator=gen), dim=-1).to(dev, dtype)
            sgot = k_coattn.coattention_one(clip[:, 2], clip[:, 0], TEMPERATURE)
            swant = k_coattn.attend_plain(clip[:, 2], clip[:, 0], TEMPERATURE)
            torch.cuda.synchronize()
            sok, serr, _ = agreement(sgot, swant, dtype)
            ok = ok and sok and rejects
            iters = 20 if p >= 1024 else 50
            k_ms = cuda_ms(lambda: k_coattn.coattention_one(q, kv, TEMPERATURE), iters)
            p_ms = cuda_ms(lambda: k_coattn.attend_plain(q, kv, TEMPERATURE), iters)
            q4, kv4 = q[:, None], kv[:, None]
            backends = _sdpa_backends(q4, kv4)
            l_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, kv4, kv4, scale=TEMPERATURE), iters)
            bound_ms, bound_by = attend_bound(b, p, c, dtype)
            rec = {"phase": "kernel", "name": "coattn_attend",
                   "dtype": str(dtype).replace("torch.", ""),
                   "B": b, "P": p, "C": c, "T": TEMPERATURE,
                   "max_abs_err": err, "rel_err": rel,
                   "max_abs_err_strided": serr,
                   "tol": {**TOL[dtype], "rel": REL_TOL[dtype]},
                   "limits_reject_zeros_and_T1": rejects, "ok": ok,
                   "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                   "library_call": "F.scaled_dot_product_attention(q, kv, kv, "
                                   "scale=T), (B, 1, P, C)",
                   "library_backends": backends,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            emit(rec)
            cases.append(rec)
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain version: "
                                     f"{dtype} P={p} max err {err} / {serr}, "
                                     f"rel {rel}, limits reject {rejects}")
    kernels.reset_launches()  # the comparison launches above do not count
    return cases


def full_width_config():
    from dcnet_tpu_torch.config import DCNetConfig
    return DCNetConfig(image_size=256, emb_size=512, lstm_hidden=512,
                       word_embedding_size=512, corpus_size=1000, query_len=20,
                       n_frames_test=5, split_corr_conv=True,
                       compute_dtype="float32")


def phase_slice(dev, profile_dir=None) -> dict:
    """The main path on the card, on the full-width YOLOv3 model."""
    from dcnet_tpu_torch.models.darknet import (
        random_darknet_weights_file, yolov3_layer_defs)
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.ops.decode import decode_best
    from dcnet_tpu_torch.weights import seeded_init_, splice_darknet_weights

    cfg = full_width_config()
    defs = yolov3_layer_defs()
    size = cfg.image_size
    n_frame = 5
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
    setup_s = time.perf_counter() - t0

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
                timing[dtype_name]["profile"] = profile_eval_clip(
                    m, images, ids, n_frame, profile_dir, dtype_name)
            except Exception as e:  # noqa: BLE001
                timing[dtype_name]["profile"] = {"error": repr(e)[:300]}
        del m
    rec = {"phase": "slice", "model": "YOLOv3/Darknet-53 + BiLSTM, 256 px, "
           "emb 512, hidden 512, corpus 1000, 5-frame clips, split corr_conv",
           "weights": "backbone: random_darknet_weights_file(seed=0) through "
                      "the port's .weights reader; rest: seeded_init_(seed=0)",
           "setup_s": setup_s, "requests": 3, "clips_per_request": 8,
           "launches": launches, "launches_per_eval_clip": 12,
           "main_path_k1": main_path_k1,
           "cpu_parity": {"clips": 2, "max_abs_outbox_err": parity_err,
                          "rtol": 1e-3, "atol": 1e-3, "same_decoded_index": same_idx,
                          "cpu_s": cpu_s},
           "timing": timing, "kind": torch.cuda.get_device_name(dev),
           "nvidia_smi": nvidia_smi()}
    emit(rec)
    return rec


def check_k1_on_mapped_features(model, images, n_frame) -> dict:
    """K1 against its plain version on the inputs eval_clip hands it: the
    model's own mapped features of one request, center frame against each
    reference at each scale, in the model's compute dtype."""
    dev = model.device
    feats = model.extract_features(images.to(dev))
    b = feats[0].shape[0] // n_frame
    center = n_frame // 2
    t = model.cfg.coattn_temperature
    worst_abs, worst_rel, ok, pairs = 0.0, 0.0, True, 0
    for f in feats:
        frames = f.reshape(b, n_frame, -1, f.shape[-1])
        for j in range(n_frame):
            if j == center:
                continue
            got = k_coattn.coattention_one(frames[:, center], frames[:, j], t)
            want = k_coattn.attend_plain(frames[:, center], frames[:, j], t)
            good, err, rel = agreement(got, want, model.dtype)
            ok, worst_abs, worst_rel = (ok and good, max(worst_abs, err),
                                        max(worst_rel, rel))
            pairs += 1
    torch.cuda.synchronize()
    kernels.reset_launches()  # comparison launches do not count
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version on the "
                             f"mapped features ({model.dtype}): max err "
                             f"{worst_abs}, rel {worst_rel}")
    return {"pairs": pairs, "max_abs_err": worst_abs, "rel_err": worst_rel,
            "tol": {**TOL[model.dtype], "rel": REL_TOL[model.dtype]}}


def profile_eval_clip(model, images, ids, n_frame, out_dir, tag) -> dict:
    """torch.profiler over one eval_clip: device time by kernel (top
    entries), summed kernel time, the host wall time of the call and their
    ratio (the device's busy share). The full table goes to `out_dir`."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.eval_clip(images, ids, n_frame=n_frame)
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
    with open(os.path.join(out_dir, f"profile_eval_clip_{tag}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))
    return {"wall_ms": wall_ms, "device_ms": total_ms,
            "device_busy_share": total_ms / wall_ms if wall_ms else None,
            "top": [{"name": k[:80], "ms": us / 1e3, "calls": n}
                    for us, k, n in rows[:12]]}


def kernels_line(cases: list, launches: dict) -> dict:
    """One entry per kernel: headline numbers at the main path's dominant
    launch (P=1024, C=512, B=8, bfloat16), every case under `cases`."""
    head = next(c for c in cases if c["P"] == 1024 and c["dtype"] == "bfloat16")
    worst = max(c["max_abs_err"] for c in cases if c["dtype"] == head["dtype"])
    return {"kernels": [{
        "name": "coattn_attend", "route": "cuda",
        "source": "dcnet_tpu_torch/csrc/coattn.cu",
        "replaces": "dcnet_tpu/ops/pallas/coattn.py:52 (_attend; body "
                    "_attend_kernel :40)",
        "launches": launches["coattn_attend"],
        "shape": {"B": head["B"], "P": head["P"], "C": head["C"],
                  "dtype": head["dtype"]},
        "max_abs_err": worst, "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "cases": [{k: c[k] for k in ("dtype", "P", "max_abs_err", "rel_err", "ms",
                                     "plain_ms", "library_ms", "bound_ms",
                                     "bound_by", "library_backends")}
                  for c in cases]}]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default="",
                    help="directory for torch.profiler tables of one "
                         "eval_clip per dtype")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    info = phase_device(dev)
    phase_build()
    cases = phase_kernel(dev)
    launches = phase_slice(dev, profile_dir=args.profile)["launches"]
    emit(kernels_line(cases, launches))
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
