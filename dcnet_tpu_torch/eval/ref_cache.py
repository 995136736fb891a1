"""The reference's per-frame `.pth` temporal cache: the port of
`dcnet_tpu/eval/ref_cache.py`.

The reference's two-pass pipeline keeps one torch pickle per frame at
`<cache>/<savename>/<video dir>/<frame stem>_<batch index>.pth` with
`pred_bbox_topk` (topk, 1, 4) xyxy boxes in original image coordinates,
`pred_score_topk` (a list of topk floats) and `visu_feat` (topk, 1, C).
These converters bridge that format and `FrameCache` in both directions.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from dcnet_tpu_torch.eval.temporal import FrameCache


def _frame_file(root: str, img_path: str, batch_idx: int) -> str:
    """`<root>/<video dir>/<image name before '.JPEG'>_<batch_idx>.pth`."""
    parts = img_path.replace("\\", "/").split("/")
    vid_name, img_name = parts[-2], parts[-1]
    stem = img_name.split(".JPEG")[0]
    return os.path.join(root, vid_name, f"{stem}_{batch_idx}.pth")


def write_reference_cache(
    root: str, frame_paths: Sequence[str], cache: FrameCache,
    batch_indices: Optional[Sequence[int]] = None,
) -> None:
    """One reference-format `.pth` per cache row, keyed by the row's
    center-frame path. Boxes must already be in original image
    coordinates."""
    boxes = torch.as_tensor(cache.boxes).float().cpu()
    scores = torch.as_tensor(cache.scores).float().cpu()
    feats = torch.as_tensor(cache.feats).float().cpu()
    for t, p in enumerate(frame_paths):
        bi = t if batch_indices is None else int(batch_indices[t])
        path = _frame_file(root, p, bi)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({
            "pred_bbox_topk": boxes[t][:, None, :].clone(),
            "pred_score_topk": [float(s) for s in scores[t]],
            "visu_feat": feats[t][:, None, :].clone(),
        }, path)


def read_reference_cache(
    root: str, frame_paths: Sequence[str],
    batch_indices: Optional[Sequence[int]] = None,
) -> FrameCache:
    """Reference-format `.pth` files -> one FrameCache on the CPU (rows in
    the order of `frame_paths`)."""
    boxes, scores, feats = [], [], []
    for t, p in enumerate(frame_paths):
        bi = t if batch_indices is None else int(batch_indices[t])
        data = torch.load(_frame_file(root, p, bi), map_location="cpu",
                          weights_only=False)
        b = np.asarray(data["pred_bbox_topk"], np.float32)
        f = data["visu_feat"]
        if isinstance(f, (list, tuple)):
            f = torch.stack(list(f))
        f = np.asarray(f, np.float32)
        boxes.append(b.reshape(b.shape[0], 4))
        scores.append(np.asarray([float(s) for s in data["pred_score_topk"]],
                                 np.float32))
        feats.append(f.reshape(f.shape[0], -1))
    return FrameCache(boxes=torch.from_numpy(np.stack(boxes)),
                      scores=torch.from_numpy(np.stack(scores)),
                      feats=torch.from_numpy(np.stack(feats)))
