"""Training losses: the port of `dcnet_tpu/losses.py`.

The five-loss objective: YOLO grounding loss, rank (hinge) loss, location
cross-entropy and the two InfoNCE correspondence losses, with the
reference's averaging (per-list means collapse to global means because
every list has the same batch size).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.models.heads import l2_normalize
from dcnet_tpu_torch.ops.correspondence import ContrastiveSamples
from dcnet_tpu_torch.ops.decode import flatten_conf
from dcnet_tpu_torch.ops.target import CompactTarget


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the batch."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[..., None])[..., 0])


def gather_pred_at_target(outbox: Sequence[torch.Tensor], tgt: CompactTarget,
                          cfg: DCNetConfig) -> torch.Tensor:
    """The 5 predicted box attributes at each sample's matched (scale,
    anchor, cell). Returns (B, 5) fp32."""
    b = outbox[0].shape[0]
    rows = torch.arange(b, device=outbox[0].device)
    picked = torch.zeros((b, 5), device=outbox[0].device)
    for s, o in enumerate(outbox):
        g = cfg.grids[s]
        cell = torch.clamp(tgt.gj, 0, g - 1) * g + torch.clamp(tgt.gi, 0, g - 1)
        vals = o.reshape(b, 3, 5, g * g)[rows, tgt.anchor, :, cell]
        picked = torch.where((tgt.best_scale == s)[:, None], vals, picked)
    return picked


def yolo_loss(outbox: Sequence[torch.Tensor], tgt: CompactTarget,
              cfg: DCNetConfig, w_coord: float = 5.0) -> torch.Tensor:
    """MSE on (sigmoid(x), sigmoid(y), w, h) at the matched anchor cell plus
    cross-entropy over all anchor-conf logits against the target slot."""
    picked = gather_pred_at_target(outbox, tgt, cfg)
    pred_xy = torch.sigmoid(picked[:, 0:2])
    pred_wh = picked[:, 2:4]
    loss_xy = torch.mean(torch.square(pred_xy - tgt.txywh[:, 0:2]), dim=0)
    loss_wh = torch.mean(torch.square(pred_wh - tgt.txywh[:, 2:4]), dim=0)
    loss_coord = (loss_xy.sum() + loss_wh.sum()) * w_coord
    return loss_coord + _cross_entropy(flatten_conf(outbox), tgt.conf_idx)


def rank_loss(sim_flat: torch.Tensor, neg_sim_flat: torch.Tensor,
              pos_idx: torch.Tensor, margin: float = 0.1) -> torch.Tensor:
    """Hinge of the positive against two negative pairings: the unaligned
    phrase at the GT position, and the aligned sim at the reversed batch's
    GT position. sim_flat, neg_sim_flat: (B, all_positions)."""
    idx = pos_idx.long()[:, None]
    pos = torch.gather(sim_flat, 1, idx)[:, 0]
    neg1 = torch.gather(neg_sim_flat, 1, idx)[:, 0]
    neg2 = torch.gather(sim_flat, 1, torch.flip(idx, dims=[0]))[:, 0]
    loss = F.relu(margin + neg1 - pos) + F.relu(margin + neg2 - pos)
    return loss.sum() / (2 * sim_flat.shape[0])


def loc_loss(loc_flat: torch.Tensor, pos_idx: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of the flattened location-score map at the GT position."""
    return _cross_entropy(loc_flat, pos_idx)


def infonce_loss(samples: ContrastiveSamples,
                 temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE over (q, k+, negatives), channel-normalised, label = the
    positive; averaged over the positive keys when there are several."""
    q = l2_normalize(samples.q)       # (B, K, C)
    k = l2_normalize(samples.k)       # (B, K, P, C)
    neg = l2_normalize(samples.neg)   # (B, K, N, C)
    l_neg = torch.einsum("bkc,bknc->bkn", q, neg)
    l_pos = torch.einsum("bkc,bkpc->bkp", q, k)
    logits = torch.cat(
        [l_pos[..., None], l_neg[:, :, None, :].expand(*l_pos.shape, l_neg.shape[-1])],
        dim=-1) / temperature         # (B, K, P, 1+N)
    return -torch.mean(torch.log_softmax(logits, dim=-1)[..., 0])


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    yolo: torch.Tensor
    rank: torch.Tensor
    loc: torch.Tensor
    interframe: torch.Tensor
    crossmodal: torch.Tensor


def total_loss(outbox: Sequence[torch.Tensor], sim_flat: torch.Tensor,
               neg_sim_flat: torch.Tensor, loc_flat: torch.Tensor,
               interframe: ContrastiveSamples, crossmodal: ContrastiveSamples,
               tgt: CompactTarget, cfg: DCNetConfig) -> LossBreakdown:
    """yolo + w_rank rank + w_loc loc + w_interframe interframe
    + w_crossmodal crossmodal (100, 1, 100, 1 by default)."""
    l_yolo = yolo_loss(outbox, tgt, cfg, w_coord=cfg.yolo_coord_weight)
    l_rank = rank_loss(sim_flat, neg_sim_flat, tgt.pos_idx, margin=cfg.rank_margin)
    l_loc = loc_loss(loc_flat, tgt.pos_idx)
    l_inter = infonce_loss(interframe, cfg.infonce_temperature)
    l_cross = infonce_loss(crossmodal, cfg.infonce_temperature)
    total = (l_yolo + cfg.w_rank * l_rank + cfg.w_loc * l_loc
             + cfg.w_interframe * l_inter + cfg.w_crossmodal * l_cross)
    return LossBreakdown(total, l_yolo, l_rank, l_loc, l_inter, l_cross)
