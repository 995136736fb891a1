"""The train and eval steps: the port of `dcnet_tpu/train/step.py`.

One train step is forward (`DCNet.forward(train=True)`, through
DistributedDataParallel over the data axis under data parallelism, and
with `cfg.tp_internals` on a mesh's model axis the co-attention's rows
split over the model group), the five-loss sum,
backward, an optimizer and schedule step, and the train metrics of the
forward's outputs; the eval step is the eval-mode forward of the same
clips, the argmax decode and acc@0.5 / center accuracy / mIoU.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.losses import gather_pred_at_target, total_loss
from dcnet_tpu_torch.ops.boxes import bbox_iou, xywh2xyxy
from dcnet_tpu_torch.ops.decode import decode_best, flatten_conf, flatten_scores
from dcnet_tpu_torch.ops.target import CompactTarget, build_target
from dcnet_tpu_torch.parallel.mesh import global_flip
from dcnet_tpu_torch.train.state import TrainState


def neg_sim_scores(corr_feat: Sequence[torch.Tensor],
                   flang_attn: torch.Tensor) -> torch.Tensor:
    """The reversed batch's phrase attention dotted with the fused visual
    features, flattened to (B, all_positions). Under data parallelism the
    reversed batch is the global one (`parallel.mesh.global_flip`)."""
    rev = global_flip(flang_attn)
    return flatten_scores([torch.einsum("bc,bhwc->bhw", rev, f.to(rev.dtype))
                           for f in corr_feat])


def pred_box_at_target(outbox: Sequence[torch.Tensor], tgt: CompactTarget,
                       cfg: DCNetConfig) -> torch.Tensor:
    """The predicted box at the ground-truth anchor and cell, (B, 4) xyxy:
    the train-time accuracy probe."""
    picked = gather_pred_at_target(outbox, tgt, cfg)
    dev = picked.device
    grid = torch.tensor(cfg.grids, dtype=torch.float32, device=dev)[tgt.best_scale]
    stride = torch.tensor(cfg.strides, dtype=torch.float32, device=dev)[tgt.best_scale]
    anchors = torch.tensor(cfg.anchors_full, dtype=torch.float32,
                           device=dev) / cfg.anchor_imsize
    aw = anchors[tgt.best_n, 0] * grid
    ah = anchors[tgt.best_n, 1] * grid
    cx = (torch.sigmoid(picked[:, 0]) + tgt.gi) * stride
    cy = (torch.sigmoid(picked[:, 1]) + tgt.gj) * stride
    bw = torch.exp(picked[:, 2]) * aw * stride
    bh = torch.exp(picked[:, 3]) * ah * stride
    return xywh2xyxy(torch.stack([cx, cy, bw, bh], dim=-1))


def _inputs(model, batch: Mapping[str, torch.Tensor]):
    dev = model.device
    bbox = torch.as_tensor(batch["bbox"], device=dev).float()
    return (torch.as_tensor(batch["images"], device=dev),
            torch.as_tensor(batch["word_ids"], device=dev),
            torch.clamp(bbox, 0, model.cfg.image_size - 1))


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """batch: images (kB, H, W, 3), word_ids (kB, L), bbox (kB, 4) xyxy.
    Updates the state in place; returns the metrics as 0-dim tensors. The
    parameters keep this step's gradients until the next step. With
    `state.ddp` (`parallel.mesh.wrap_ddp` of the model) the forward runs
    through it: the batch is this rank's shard, the gradients are averaged
    over the data ranks and the metrics are this rank's."""
    model = state.model
    cfg = model.cfg
    images, word_ids, bbox = _inputs(model, batch)
    forward = state.ddp if state.ddp is not None else model
    out = forward(images, word_ids, train=True, generator=generator)
    tgt = build_target(bbox, cfg)
    lb = total_loss(out.outbox, flatten_scores(out.sim_score),
                    neg_sim_scores(out.corr_feat, out.flang_attn),
                    flatten_scores(out.loc_score), out.interframe,
                    out.crossmodal, tgt, cfg)
    state.optimizer.zero_grad(set_to_none=True)
    lb.total.backward()
    for prm in model.parameters():
        # a parameter outside the loss's graph (feature_map only smooths the
        # map the top-k indices are read from) gets a zero gradient, as in
        # JAX, so weight decay still moves it as optax moves it
        if prm.requires_grad and prm.grad is None:
            prm.grad = torch.zeros_like(prm)
    state.optimizer.step()
    state.schedule.step()
    state.step += 1

    with torch.no_grad():
        iou = bbox_iou(pred_box_at_target(out.outbox, tgt, cfg), bbox)
        center_ok = torch.argmax(flatten_conf(out.outbox), dim=1) == tgt.conf_idx
        metrics = {"loss": lb.total, "loss_yolo": lb.yolo, "loss_rank": lb.rank,
                   "loss_loc": lb.loc, "loss_interframe": lb.interframe,
                   "loss_crossmodal": lb.crossmodal,
                   "acc50": torch.mean((iou > 0.5).float()),
                   "acc_center": torch.mean(center_ok.float()),
                   "miou": torch.mean(iou)}
        return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(model, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The validate body: eval-mode forward on the clips, argmax decode,
    acc@0.5, center accuracy and mIoU."""
    cfg = model.cfg
    images, word_ids, bbox = _inputs(model, batch)
    out = model(images, word_ids, train=False,
                generator=torch.Generator(device=model.device).manual_seed(0))
    tgt = build_target(bbox, cfg)
    dec = decode_best(out.outbox, cfg)
    iou = bbox_iou(dec.boxes[:, 0], bbox)
    center_ok = ((dec.gi[:, 0] == tgt.gi) & (dec.gj[:, 0] == tgt.gj)
                 & (dec.scale[:, 0] == tgt.best_scale))
    return {"acc50": torch.mean((iou > 0.5).float()),
            "acc_center": torch.mean(center_ok.float()),
            "miou": torch.mean(iou)}
