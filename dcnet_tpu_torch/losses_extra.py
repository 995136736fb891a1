"""Auxiliary losses of the reference that its main path never calls: the
port of `dcnet_tpu/losses_extra.py`, vectorised as there. No path of
either package calls them.

- `offset_loss` / `confidence_loss`: the pairwise frame-offset MSE and the
  pair confidence-consistency MSE of the reference's training script.
- `iou_loss`: 1 - mean IoU.
- `weighted_ce_loss`: cross-entropy scaled by (1 - p_correct)^gamma.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.losses import gather_pred_at_target
from dcnet_tpu_torch.ops.boxes import bbox_iou
from dcnet_tpu_torch.ops.decode import flatten_conf
from dcnet_tpu_torch.ops.target import CompactTarget


def offset_loss(outbox: Sequence[torch.Tensor], tgt: CompactTarget,
                cfg: DCNetConfig, w_coord: float = 5.0) -> torch.Tensor:
    """MSE between the within-clip frame-pair offsets of the predicted and
    the target (tx, ty, tw, th); the batch is interleaved pairs."""
    picked = gather_pred_at_target(outbox, tgt, cfg)  # (2B, 5)
    pred = torch.cat([torch.sigmoid(picked[:, 0:2]), picked[:, 2:4]], dim=1)
    pred = pred.reshape(-1, 2, 4)
    gt = tgt.txywh.reshape(-1, 2, 4)
    d_pred = pred[:, 0] - pred[:, 1]
    d_gt = gt[:, 0] - gt[:, 1]
    return torch.mean(torch.square(d_pred - d_gt), dim=0).sum() * w_coord


def confidence_loss(outbox: Sequence[torch.Tensor]) -> torch.Tensor:
    """MSE between the confidence maps of the two frames of each clip."""
    conf = flatten_conf(outbox)                 # (2B, n_slots)
    conf = conf.reshape(-1, 2, conf.shape[-1])
    return torch.mean(torch.square(conf[:, 0] - conf[:, 1]))


def iou_loss(pred_xyxy: torch.Tensor, gt_xyxy: torch.Tensor) -> torch.Tensor:
    """Soft-IoU loss: 1 - mean IoU."""
    return 1.0 - torch.mean(bbox_iou(pred_xyxy, gt_xyxy))


def weighted_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                     gamma: float = 2.0) -> torch.Tensor:
    """Focal-style weighted cross-entropy: CE scaled by (1 - p)^gamma."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    p = torch.exp(picked)
    return -torch.mean(((1.0 - p) ** gamma) * picked)
