"""Standalone temporal post-processing (pass 2 of 2): the port of
`dcnet_tpu/cli/post_process.py`.

Pass 1 writes a cache with `dcnet_tpu_torch.cli.test --cache --cache_dir
...` (one `cache.npz` per run, the JAX package's keys); this entry point
fuses it per video and scores the fused boxes. `--ref_cache` reads the
reference's per-frame `.pth` cache instead, with the ground truth taken from
the dataset index. Prints `acc,miou`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dcnet_tpu_torch.cli.common import base_parser, check_ported, cli_device, setup_logging
from dcnet_tpu_torch.eval.metrics import AverageMeter
from dcnet_tpu_torch.eval.temporal import FrameCache, fuse_per_video
from dcnet_tpu_torch.ops.boxes import bbox_iou


def save_cache_npz(path: str, cache: FrameCache, gt_boxes: np.ndarray,
                   ratios: np.ndarray, dws: np.ndarray, dhs: np.ndarray,
                   paths=None, video_ids=None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    host = {f: torch.as_tensor(getattr(cache, f)).cpu().numpy() for f in FrameCache._fields}
    np.savez_compressed(
        path, boxes=host["boxes"], scores=host["scores"], feats=host["feats"],
        gt_boxes=gt_boxes, ratios=ratios, dws=dws, dhs=dhs,
        video_ids=np.asarray(
            video_ids if video_ids is not None
            else np.zeros(len(gt_boxes), np.int32)),
        paths=np.asarray(paths if paths is not None else [], dtype=object))


def load_cache_npz(path: str, device=None):
    """(FrameCache on `device` (the CPU by default), the npz's arrays)."""
    data = np.load(path, allow_pickle=True)
    cache = FrameCache(*(torch.from_numpy(data[f]).to(device or "cpu")
                         for f in FrameCache._fields))
    return cache, data


def _score(fused: torch.Tensor, gts) -> AverageMeter:
    acc, miou = AverageMeter(), AverageMeter()
    for t in range(fused.shape[0]):
        iou = float(bbox_iou(fused[t][None].float(),
                             torch.as_tensor(gts[t], dtype=torch.float32)[None])[0])
        acc.update(float(iou > 0.5))
        miou.update(iou)
    print(f"{acc.avg:.6f},{miou.avg:.6f}")
    return acc


def main(argv=None):
    parser = base_parser("dcnet_tpu_torch temporal post-processing")
    parser.add_argument("--cache_dir", default="./cache", type=str)
    parser.add_argument("--ref_cache", action="store_true",
                        help="read the reference's per-frame .pth cache "
                             "instead of cache.npz")
    args = parser.parse_args(argv)
    if args.savename == "default":
        args.savename = f"model_{args.dataset}_batch{args.batch_size}"
    device = cli_device()
    setup_logging(args.savename, test=True)
    k = args.num_frame_k if args.num_frame_k != 2 else 5

    if args.ref_cache:
        return _ref_cache_main(args, k, device)

    cache, data = load_cache_npz(
        os.path.join(args.cache_dir, args.savename, "cache.npz"), device)
    # per-video fusion; caches without video ids fuse as one video
    video_ids = (data["video_ids"] if "video_ids" in data.files
                 else np.zeros(int(cache.boxes.shape[0]), np.int32))
    fused = fuse_per_video(cache, video_ids, ref_frames=k).cpu().numpy()
    preds, gts = [], []
    for t in range(fused.shape[0]):  # back to original image coordinates
        ratio, dw, dh = (float(data[n][t]) for n in ("ratios", "dws", "dhs"))
        gt = data["gt_boxes"][t].astype(np.float64)
        pred = fused[t].astype(np.float64)
        for b in (gt, pred):
            b[[0, 2]] = (b[[0, 2]] - dw) / ratio
            b[[1, 3]] = (b[[1, 3]] - dh) / ratio
        preds.append(pred)
        gts.append(gt)
    return _score(torch.tensor(np.stack(preds)), gts).avg


def _ref_cache_main(args, k: int, device):
    """Fuse a cache in the reference's per-frame .pth format; boxes and
    ground truth are in original image coordinates."""
    from dcnet_tpu_torch.cli.common import build_dataset
    from dcnet_tpu_torch.eval.ref_cache import read_reference_cache

    check_ported(args, "cli.post_process")
    ds, _ = build_dataset(args, "test", testmode=True)
    center = k // 2
    paths, gts, vids = [], [], []
    for cpaths, cboxes, _, vid in ds.chunks:
        paths.append(cpaths[center])
        gts.append(np.asarray(cboxes[center], np.float64))
        vids.append(vid)
    cache = read_reference_cache(os.path.join(args.cache_dir, args.savename), paths)
    cache = FrameCache(*(x.to(device) for x in cache))
    fused = fuse_per_video(cache, np.asarray(vids), ref_frames=k).cpu()
    return _score(fused, gts).avg


if __name__ == "__main__":
    main()
