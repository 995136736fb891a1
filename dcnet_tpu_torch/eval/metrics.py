"""Evaluation metrics: the port of the grounding metrics of
`dcnet_tpu/eval/metrics.py` (acc@0.5, center accuracy, mean IoU) and its
running average."""

from __future__ import annotations

from typing import Dict

import torch


class AverageMeter:
    """Running average."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def grounding_metrics(iou: torch.Tensor, pred_gi: torch.Tensor,
                      pred_gj: torch.Tensor, pred_scale: torch.Tensor,
                      tgt_gi: torch.Tensor, tgt_gj: torch.Tensor,
                      tgt_scale: torch.Tensor) -> Dict[str, torch.Tensor]:
    """acc@0.5, center accuracy (same cell at the same scale), mean IoU."""
    acc = (iou > 0.5).float().mean()
    center = ((pred_gi == tgt_gi) & (pred_gj == tgt_gj)
              & (pred_scale == tgt_scale)).float().mean()
    return {"acc50": acc, "acc_center": center, "miou": iou.mean()}
