"""The YOLOv3 80-class detection decode and its target building: the port
of `dcnet_tpu/ops/yolo_detect.py`.

The reference model carries a full YOLO detection layer that DCNet runs and
discards; the JAX package keeps it for parity, and so does the port.
- `yolo_detections`: the sigmoid / exp anchor decode of a (B, A(5+C), g, g)
  or (B, g, g, A(5+C)) head output into (B, A g g, 5+C) detections at
  image scale;
- `build_object_targets`: the multi-object anchor assignment with the
  ignore-threshold mask, over the batch and a zero-padded object list.

Plain functions on tensors, on the device of their input (the JAX package
has no kernel here: the decode is elementwise, the assignment a small
scatter). Where two objects of a row land in the same cell and anchor, the
later one's `set` wins, as an ordered scatter gives it, on every device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from dcnet_tpu_torch.ops.boxes import wh_iou

# COCO 91 -> 80 category remap
EXIST_ID = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90)


def coco_category_map() -> Dict[int, int]:
    return {cid: i for i, cid in enumerate(EXIST_ID)}


def yolo_detections(head_out: torch.Tensor, anchors: Sequence[Tuple[float, float]],
                    num_classes: int, img_dim: int) -> torch.Tensor:
    """head_out: (B, A(5+C), g, g) or (B, g, g, A(5+C)). Returns (B, A g g,
    5+C): [x, y, w, h (image px), conf, class probabilities]. The anchors
    are scaled by the reference's hardcoded 416."""
    a = len(anchors)
    attrs = 5 + num_classes
    if head_out.shape[1] == a * attrs:  # NCHW
        b, _, g, _ = head_out.shape
        pred = head_out.reshape(b, a, attrs, g, g).permute(0, 1, 3, 4, 2)
    else:  # NHWC
        b, g, _, _ = head_out.shape
        pred = head_out.reshape(b, g, g, a, attrs).permute(0, 3, 1, 2, 4)
    dev = head_out.device
    stride = img_dim / g
    gx = torch.arange(g, dtype=torch.float32, device=dev)[None, :].expand(g, g)
    gy = torch.arange(g, dtype=torch.float32, device=dev)[:, None].expand(g, g)
    anchors_s = torch.tensor(anchors, dtype=torch.float32, device=dev) / (416.0 / g)  # (A, 2)
    x = (torch.sigmoid(pred[..., 0]) + gx) * stride
    y = (torch.sigmoid(pred[..., 1]) + gy) * stride
    w = torch.exp(pred[..., 2]) * anchors_s[None, :, None, None, 0] * stride
    h = torch.exp(pred[..., 3]) * anchors_s[None, :, None, None, 1] * stride
    conf = torch.sigmoid(pred[..., 4])
    cls = torch.sigmoid(pred[..., 5:])
    out = torch.cat([torch.stack([x, y, w, h, conf], dim=-1), cls], dim=-1)
    return out.reshape(b, a * g * g, attrs)


class ObjectTargets(NamedTuple):
    mask: torch.Tensor       # (B, A, g, g) responsible-anchor mask
    conf_mask: torch.Tensor  # (B, A, g, g) negatives mask (ignore region = 0)
    txywh: torch.Tensor      # (B, A, g, g, 4)
    tconf: torch.Tensor      # (B, A, g, g)
    tcls: torch.Tensor       # (B, A, g, g) int class index


def _last_writes(flat: torch.Tensor, size: int) -> torch.Tensor:
    """The positions of `flat` (indices below `size`) that hold the last
    occurrence of their index: the writes an ordered scatter's `set` keeps."""
    order = torch.arange(flat.numel(), device=flat.device)
    last = torch.full((size,), -1, dtype=torch.long, device=flat.device)
    last.scatter_reduce_(0, flat, order, reduce="amax")
    return last[flat] == order


def build_object_targets(targets: torch.Tensor, anchors: Sequence[Tuple[float, float]],
                         grid_size: int, ignore_thres: float = 0.5) -> ObjectTargets:
    """targets: (B, T, 5) rows [class, cx, cy, w, h] normalised to [0, 1],
    all-zero rows padding. Anchors are in grid units."""
    b, t, _ = targets.shape
    a, g, dev = len(anchors), grid_size, targets.device
    anchors_a = torch.tensor(anchors, dtype=torch.float32, device=dev)
    valid = targets.abs().sum(dim=2) > 0                             # (B, T)
    gx, gy = targets[..., 1] * g, targets[..., 2] * g
    gw, gh = targets[..., 3] * g, targets[..., 4] * g
    gi = gx.to(torch.int64).clamp(0, g - 1)
    gj = gy.to(torch.int64).clamp(0, g - 1)
    ious = wh_iou(torch.stack([gw, gh], -1)[..., None, :], anchors_a[None, None])  # (B, T, A)
    best_n = ious.argmax(dim=2)
    # each object's cell at every anchor, as a flat (B, A, g, g) index
    bidx = torch.arange(b, device=dev)[:, None, None]
    every = ((bidx * a + torch.arange(a, device=dev)) * g + gj[..., None]) * g + gi[..., None]
    cells = b * a * g * g

    # the ignore region: anchors with IoU above the threshold at the object's cell
    ign = (ious > ignore_thres) & valid[..., None]                    # (B, T, A)
    conf_mask = torch.ones(cells, dtype=torch.float32, device=dev)
    conf_mask.index_add_(0, every.reshape(-1), -ign.to(torch.float32).reshape(-1))
    conf_mask = conf_mask.clamp(0.0, 1.0)

    # the responsible anchor
    flat = every.gather(2, best_n[..., None]).reshape(-1)
    vw = valid.to(torch.float32).reshape(-1)
    mask = torch.zeros(cells, dtype=torch.float32, device=dev)
    mask.scatter_reduce_(0, flat, vw, reduce="amax")
    conf_mask.scatter_reduce_(0, flat, vw, reduce="amax")
    tconf = mask.clone()
    aw, ah = anchors_a[best_n, 0], anchors_a[best_n, 1]
    vals = torch.stack([gx - gi, gy - gj, torch.log(gw / aw + 1e-16),
                        torch.log(gh / ah + 1e-16)], -1) * valid[..., None]
    keep = _last_writes(flat, cells)
    txywh = torch.zeros(cells, 4, dtype=torch.float32, device=dev)
    txywh[flat[keep]] = vals.reshape(-1, 4)[keep]
    tcls = torch.zeros(cells, dtype=torch.int32, device=dev)
    tcls[flat[keep]] = (targets[..., 0].to(torch.int32) * valid).reshape(-1)[keep]
    shape = (b, a, g, g)
    return ObjectTargets(mask.reshape(shape), conf_mask.reshape(shape),
                         txywh.reshape(*shape, 4), tconf.reshape(shape), tcls.reshape(shape))
