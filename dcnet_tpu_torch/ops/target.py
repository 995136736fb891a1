"""Vectorised YOLO target construction: the port of `dcnet_tpu/ops/target.py`.

A *compact* target per sample (the matched anchor, cell, regression targets
and the flat indices the losses read) instead of the sparse per-scale
target tensors: every consumer reads only the one non-zero entry. The 9
anchor IoUs are taken at normalised scale (IoU is invariant under the
common per-scale rescaling of box and anchor). Integer casts truncate toward
zero, as `astype(int32)` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.ops.boxes import wh_iou
from dcnet_tpu_torch.utils.profiling import count_sync


class CompactTarget(NamedTuple):
    """Per-sample matched ground truth; every field has leading dim B."""

    best_n: torch.Tensor      # (B,) int in [0, 9): global anchor index
    best_scale: torch.Tensor  # (B,) int in [0, 3)
    anchor: torch.Tensor      # (B,) int in [0, 3): anchor within the scale
    gi: torch.Tensor          # (B,) grid column at the best scale
    gj: torch.Tensor          # (B,) grid row at the best scale
    txywh: torch.Tensor       # (B, 4) float: tx, ty, tw, th
    conf_idx: torch.Tensor    # (B,) index into the 3*sum(g^2) conf vector
    pos_idx: torch.Tensor     # (B,) index into the sum(g^2) position vector


def build_target(bbox_xyxy: torch.Tensor, cfg: DCNetConfig) -> CompactTarget:
    """bbox_xyxy: (B, 4) ground-truth boxes in letterboxed pixels."""
    dev = bbox_xyxy.device
    count_sync(dev, 4)   # the four tables below, copied from the host
    box = bbox_xyxy.float()
    size = float(cfg.image_size)
    cx = (box[:, 0] + box[:, 2]) / (2.0 * size)
    cy = (box[:, 1] + box[:, 3]) / (2.0 * size)
    w = (box[:, 2] - box[:, 0]) / size
    h = (box[:, 3] - box[:, 1]) / size

    anchors = torch.tensor(cfg.anchors_full, dtype=torch.float32,
                           device=dev) / float(cfg.anchor_imsize)
    ious = wh_iou(torch.stack([w, h], dim=-1)[:, None, :], anchors[None])  # (B, 9)
    best_n = torch.argmax(ious, dim=1)
    best_scale = best_n // 3
    anchor = best_n % 3

    grids = torch.tensor(cfg.grids, dtype=torch.int64, device=dev)
    g = grids[best_scale]
    grid = g.float()
    gx, gy = cx * grid, cy * grid
    gi = torch.minimum(torch.clamp(gx.to(torch.int32).long(), min=0), g - 1)
    gj = torch.minimum(torch.clamp(gy.to(torch.int32).long(), min=0), g - 1)
    tx = gx - gi.float()
    ty = gy - gj.float()

    aw = anchors[best_n, 0] * grid
    ah = anchors[best_n, 1] * grid
    tw = torch.log(w * grid / aw + 1e-16)
    th = torch.log(h * grid / ah + 1e-16)

    conf_offs = torch.tensor(cfg.scale_offsets(), dtype=torch.int64, device=dev)
    pos_offs = torch.tensor(cfg.position_offsets(), dtype=torch.int64, device=dev)
    conf_idx = conf_offs[best_scale] + anchor * g * g + gj * g + gi
    pos_idx = pos_offs[best_scale] + gj * g + gi
    return CompactTarget(best_n=best_n, best_scale=best_scale, anchor=anchor,
                         gi=gi, gj=gj, txywh=torch.stack([tx, ty, tw, th], -1),
                         conf_idx=conf_idx, pos_idx=pos_idx)
