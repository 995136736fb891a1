"""Epoch-level training: the port of `dcnet_tpu/train/loop.py`.

`train_epoch` and `validate` run over batches already in memory (numpy
arrays or CPU tensors, as a data loader yields them), move each to the
model's device (pinned memory and `non_blocking` copies to a CUDA card),
and keep the metric meters. Clip batches (B, k, ...) are flattened to the
(B*k, ...) layout the steps take.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from dcnet_tpu_torch.eval.metrics import AverageMeter
from dcnet_tpu_torch.train.state import TrainState
from dcnet_tpu_torch.train.step import eval_step, train_step

log = logging.getLogger("dcnet_tpu_torch")

_CLIP_NDIM = {"images": 5, "word_ids": 3, "word_mask": 3, "bbox": 3}


def flatten_clip_batch(batch: Mapping[str, object]) -> Dict[str, object]:
    """(B, k, ...) -> (B*k, ...) for images/word_ids/bbox; flat batches pass
    through unchanged."""
    out = {}
    for k, v in batch.items():
        if hasattr(v, "ndim") and v.ndim == _CLIP_NDIM.get(k, -1):
            out[k] = v.reshape(-1, *v.shape[2:])
        else:
            out[k] = v
    return out


def to_device(batch: Mapping[str, object], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """Every array of the batch as a tensor on `device`; to a CUDA device
    through pinned memory with non-blocking copies."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if not isinstance(v, torch.Tensor):
            out[k] = v
        elif device.type == "cuda" and v.device.type == "cpu":
            out[k] = v.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = v.to(device)
    return out


def train_epoch(state: TrainState, batches: Iterable[Mapping[str, object]],
                epoch: int, print_freq: int = 100,
                max_steps: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                should_stop: Optional[Callable[[], bool]] = None
                ) -> Dict[str, float]:
    """One epoch of `train_step`s; returns the epoch's metric averages.
    `should_stop` is polled between steps (the preemption hook)."""
    meters = {k: AverageMeter() for k in
              ("loss", "loss_yolo", "loss_rank", "loss_loc", "loss_interframe",
               "loss_crossmodal", "acc50", "acc_center", "miou", "batch_time")}
    device = state.model.device
    end = time.time()
    for i, batch in enumerate(batches):
        if max_steps is not None and i >= max_steps:
            break
        if should_stop is not None and should_stop():
            log.info("stop requested at step %d of epoch %d", i, epoch)
            break
        batch = to_device(flatten_clip_batch(batch), device)
        n = batch["images"].shape[0]
        metrics = train_step(state, batch, generator)
        for k, v in metrics.items():
            meters[k].update(float(v), n)
        meters["batch_time"].update(time.time() - end)
        end = time.time()
        if i % print_freq == 0:
            msg = (f"Epoch [{epoch}][{i}] "
                   + " ".join(f"{k} {m.val:.4f} ({m.avg:.4f})"
                              for k, m in meters.items()))
            print(msg, flush=True)
            log.info(msg)
    return {k: m.avg for k, m in meters.items()}


def validate(model, batches: Iterable[Mapping[str, object]],
             max_steps: Optional[int] = None) -> Dict[str, float]:
    """`eval_step` over the batches; returns acc50, acc_center and miou."""
    meters = {k: AverageMeter() for k in ("acc50", "acc_center", "miou")}
    for i, batch in enumerate(batches):
        if max_steps is not None and i >= max_steps:
            break
        batch = to_device(flatten_clip_batch(batch), model.device)
        n = batch["images"].shape[0]
        for k, v in eval_step(model, batch).items():
            meters[k].update(float(v), n)
    result = {k: m.avg for k, m in meters.items()}
    log.info("%f,%f,%f", result["acc50"], result["miou"], result["acc_center"])
    return result
