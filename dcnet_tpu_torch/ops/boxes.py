"""Vectorised box utilities: the port of `dcnet_tpu/ops/boxes.py`. All
functions take arbitrary leading batch dims."""

from __future__ import annotations

import torch


def xyxy2xywh(boxes: torch.Tensor) -> torch.Tensor:
    """[x1, y1, x2, y2] -> [cx, cy, w, h]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def xywh2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[cx, cy, w, h] -> [x1, y1, x2, y2]."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xyxy: bool = True) -> torch.Tensor:
    """Elementwise IoU of aligned box arrays (..., 4)."""
    if not xyxy:
        box1, box2 = xywh2xyxy(box1), xywh2xyxy(box2)
    x1 = torch.maximum(box1[..., 0], box2[..., 0])
    y1 = torch.maximum(box1[..., 1], box2[..., 1])
    x2 = torch.minimum(box1[..., 2], box2[..., 2])
    y2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    a1 = (box1[..., 2] - box1[..., 0]) * (box1[..., 3] - box1[..., 1])
    a2 = (box2[..., 2] - box2[..., 0]) * (box2[..., 3] - box2[..., 1])
    return inter / (a1 + a2 - inter + 1e-16)


def bbox_iou_pairwise(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) -> (N, M) IoU matrix."""
    return bbox_iou(box1[:, None, :], box2[None, :, :])


def wh_iou(wh1: torch.Tensor, wh2: torch.Tensor) -> torch.Tensor:
    """IoU of boxes given only by (w, h), both centred at the origin."""
    w1, h1 = wh1[..., 0], wh1[..., 1]
    w2, h2 = wh2[..., 0], wh2[..., 1]
    inter = torch.minimum(w1, w2) * torch.minimum(h1, h2)
    return inter / (w1 * h1 + w2 * h2 - inter + 1e-16)
