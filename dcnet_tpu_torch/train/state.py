"""Train state and optimizer: the port of `dcnet_tpu/train/state.py`.

The reference recipe is torch's own: `torch.optim.RMSprop(alpha=0.99,
eps=1e-8, weight_decay=wd)` is exactly the JAX package's
`add_decayed_weights` + `scale_by_torch_rmsprop` (decay folded into the
gradient before the square average, eps outside the sqrt); Adam is
`torch.optim.Adam(weight_decay=wd)` (decay added to the gradient, as
`add_decayed_weights` before `scale_by_adam`); SGD is
`torch.optim.SGD(momentum=0.99)` without decay (`optax.trace(0.99)`). Two
parameter groups, the backbone (`visumodel`) at lr * backbone_lr_scale, and
the per-epoch poly decay base_lr * max(1 - epoch / nb_epoch, 0) ** power,
stepped once per step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch
from torch import nn

from dcnet_tpu_torch.config import DCNetConfig


def poly_epoch_factor(nb_epoch: int, power: float,
                      steps_per_epoch: int) -> Callable[[int], float]:
    """step -> the lr multiplier (1 - epoch / nb_epoch) ** power, 0 after
    the last epoch."""

    def factor(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return max(1.0 - epoch / nb_epoch, 0.0) ** power

    return factor


def param_groups(model: nn.Module, cfg: DCNetConfig) -> List[Dict]:
    """The backbone group at lr * backbone_lr_scale, the rest at lr."""
    named = list(model.named_parameters())
    return [
        {"params": [p for n, p in named if n.startswith("visumodel.")],
         "lr": cfg.lr * cfg.backbone_lr_scale},
        {"params": [p for n, p in named if not n.startswith("visumodel.")],
         "lr": cfg.lr},
    ]


def make_optimizer(cfg: DCNetConfig, model: nn.Module) -> torch.optim.Optimizer:
    groups = param_groups(model, cfg)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(groups, lr=cfg.lr, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(groups, lr=cfg.lr, momentum=0.99)
    if cfg.optimizer != "rmsprop":
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return torch.optim.RMSprop(groups, lr=cfg.lr, alpha=0.99, eps=1e-8,
                               weight_decay=cfg.weight_decay)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the poly schedule and the step count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def create_train_state(model: nn.Module, cfg: DCNetConfig,
                       steps_per_epoch: int = 1000) -> TrainState:
    optimizer = make_optimizer(cfg, model)
    schedule = torch.optim.lr_scheduler.LambdaLR(
        optimizer, poly_epoch_factor(cfg.nb_epoch, cfg.poly_power,
                                     steps_per_epoch))
    return TrainState(model=model, optimizer=optimizer, schedule=schedule)
