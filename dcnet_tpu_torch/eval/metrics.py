"""Evaluation metrics: the port of `dcnet_tpu/eval/metrics.py` -- the
grounding metrics (acc@0.5, center accuracy, mean IoU), the running
average, multiclass precision/recall/F1, confusion-matrix segmentation
metrics and VOC-style AP (the last three numpy, as in the JAX package)."""

from __future__ import annotations

from typing import Dict

import numpy as np
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


def multiclass_metrics(pred: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    """Precision/recall/F1 at a 0.5 threshold (-1 where undefined)."""
    eps = 1e-6
    pred_ind = (pred > 0.5).astype(int)
    gt_ind = (gt > 0.5).astype(int)
    nc = int((pred_ind * gt_ind).sum())
    np_, nr = int(pred_ind.sum()), int(gt_ind.sum())
    out = {"precision": -1.0, "recall": -1.0, "f1": -1.0}
    if np_ > 0:
        out["precision"] = nc / np_
    if nr > 0:
        out["recall"] = nc / nr
    if np_ > 0 and nr > 0:
        p, r = out["precision"], out["recall"]
        out["f1"] = 2 * p * r / (p + r + eps)
    return out


def segmentation_metrics(label_trues, label_preds, n_class: int) -> Dict[str, float]:
    """Confusion-matrix pixel metrics: acc, mean class acc, mean IU,
    frequency-weighted IU."""
    hist = np.zeros((n_class, n_class))
    for lt, lp in zip(label_trues, label_preds):
        mask = (lt >= 0) & (lt < n_class)
        hist += np.bincount(
            n_class * lt[mask].astype(int) + lp[mask].astype(int),
            minlength=n_class ** 2).reshape(n_class, n_class)
    acc = np.diag(hist).sum() / max(hist.sum(), 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc_cls = np.diag(hist) / hist.sum(axis=1)
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0)
                              - np.diag(hist))
    freq = hist.sum(axis=1) / max(hist.sum(), 1)
    fwavacc = (freq[freq > 0] * np.nan_to_num(iu)[freq > 0]).sum()
    return {"acc": float(acc), "acc_cls": float(np.nanmean(acc_cls)),
            "mean_iu": float(np.nanmean(iu)), "fwavacc": float(fwavacc)}


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """VOC-style AP: the area under the monotone precision envelope."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
