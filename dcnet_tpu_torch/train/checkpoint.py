"""Checkpoints: the port of `dcnet_tpu/train/checkpoint.py`.

`save_checkpoint` writes `<ckpt_dir>/<epoch>.pth.tar` with `torch.save`
and keeps the latest `keep` files. Each file is a superset of the
reference's wrapper `{epoch, state_dict, best_loss, optimizer}`:
`state_dict` is the model's, in the reference namespace (so the reference
code and `weights.load_into` read it as it is), `best_loss` holds the best
accuracy as the reference's did, and `optimizer` the torch optimizer's
state; beside them `best_acc`, `step` and the poly schedule's state. The
train CLI reseeds its sampling and dropout streams from (seed, epoch) at
each epoch, so a run resumed after epoch e equals the uninterrupted one.
`restore_checkpoint` reads the latest (or a given) epoch back,
`load_pretrain` splices in whatever parameters and statistics match by
name and shape.

The reference converters are nearly the identity here: the port's modules
carry the reference names. `convert_reference_state_dict` drops a `module.`
prefix, reads the BERT body's LayerNorm `gamma` / `beta` as `weight` /
`bias`, drops `textmodel.pooler.*` (the mean-of-[CLS] readout does not use
it) and reports the port's keys it never wrote (`textmodel.proj.*` has no
reference counterpart). An orbax checkpoint directory of the JAX package
is not read here: restore it with the JAX package and carry its trees
across with `weights.state_dict_from_jax`.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dcnet_tpu_torch.train.state import TrainState
from dcnet_tpu_torch.weights import load_into

_CKPT = re.compile(r"^(\d+)\.pth\.tar$")


def checkpoint_epochs(ckpt_dir: str) -> list:
    """The epochs with a checkpoint file in `ckpt_dir`, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(ckpt_dir)) if m)


def checkpoint_path(ckpt_dir: str, epoch: Optional[int] = None) -> str:
    """The file of `epoch` (the latest when None). An orbax directory (step
    subdirectories, no `.pth.tar`) raises."""
    epochs = checkpoint_epochs(ckpt_dir)
    if not epochs:
        if os.path.isdir(ckpt_dir) and any(
                n.isdigit() and os.path.isdir(os.path.join(ckpt_dir, n))
                for n in os.listdir(ckpt_dir)):
            raise NotImplementedError(
                f"{ckpt_dir} is an orbax checkpoint directory of the JAX package: "
                "restore it with the JAX package (dcnet_tpu.train.checkpoint."
                "restore_checkpoint) and carry its params and batch_stats across "
                "with dcnet_tpu_torch.weights.state_dict_from_jax")
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    epoch = epochs[-1] if epoch is None else epoch
    return os.path.join(ckpt_dir, f"{epoch}.pth.tar")


def _cpu(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int,
                    best_acc: float, keep: int = 3) -> str:
    """Write `<ckpt_dir>/<epoch>.pth.tar` and delete all but the latest
    `keep` checkpoint files. Returns the path written."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{epoch}.pth.tar")
    blob = {"epoch": epoch, "state_dict": _cpu(state.model.state_dict()),
            "best_loss": best_acc, "best_acc": best_acc, "step": state.step,
            "optimizer": state.optimizer.state_dict(),
            "schedule": state.schedule.state_dict()}
    torch.save(blob, path + ".tmp")
    os.replace(path + ".tmp", path)  # a reader never sees half a file
    for old in checkpoint_epochs(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, f"{old}.pth.tar"))
    return path


def restore_checkpoint(ckpt_dir: str, state: TrainState,
                       epoch: Optional[int] = None,
                       with_opt_state: bool = True
                       ) -> Tuple[TrainState, int, float]:
    """Full restore (`--resume`): the model's weights and statistics and,
    with `with_opt_state`, the optimizer, schedule and step. Returns
    (state, next epoch, best_acc). The eval CLIs pass with_opt_state=False
    (weights only)."""
    blob = torch.load(checkpoint_path(ckpt_dir, epoch), map_location="cpu",
                      weights_only=False)
    load_into(state.model, blob["state_dict"])
    if with_opt_state:
        state.optimizer.load_state_dict(blob["optimizer"])
        state.schedule.load_state_dict(blob["schedule"])
        state.step = int(blob["step"])
    return state, int(blob["epoch"]) + 1, float(blob["best_acc"])


def load_pretrain(ckpt_dir: str, state: TrainState) -> TrainState:
    """`--pretrain`: load every tensor of the latest checkpoint (or of a
    `.pth.tar` file) whose name and shape the model shares; keep the rest.
    Raises when none matches."""
    path = ckpt_dir if os.path.isfile(ckpt_dir) else checkpoint_path(ckpt_dir)
    blob = torch.load(path, map_location="cpu", weights_only=False)
    loaded = blob.get("state_dict", blob)
    current = state.model.state_dict()
    hits = {k: v for k, v in loaded.items()
            if k in current and tuple(current[k].shape) == tuple(v.shape)}
    if not hits:
        raise ValueError(f"pretrain checkpoint {path} shares no parameters")
    current.update(hits)
    load_into(state.model, current)
    return state


class ConversionReport:
    """What a reference state_dict conversion touched: `matched` keys,
    `skipped` ones (the pooler), `unmatched` (no key of the model: strict
    mode raises on them) and `untouched` (keys of the model the state_dict
    never wrote)."""

    def __init__(self):
        self.matched: list = []
        self.skipped: list = []
        self.unmatched: list = []
        self.untouched: list = []

    def __repr__(self):
        return (f"ConversionReport(matched={len(self.matched)}, "
                f"skipped={len(self.skipped)}, unmatched={self.unmatched[:8]}, "
                f"untouched={self.untouched[:8]})")


def convert_reference_state_dict(state_dict: Mapping[str, Any], model: nn.Module,
                                 strict: bool = True
                                 ) -> Tuple[Dict[str, Any], ConversionReport]:
    """A reference `.pth.tar` state_dict (optionally DDP `module.`-prefixed,
    BERT LayerNorms as gamma/beta, with the BERT pooler) -> the model's
    state_dict with the reference's values, the model's own values where
    the reference has none (reported as untouched; in strict mode only
    `textmodel.proj.*` may be). `num_batches_tracked` counters are taken
    where present and not reported."""
    own = model.state_dict()
    out: Dict[str, Any] = {}
    report = ConversionReport()
    for k, v in state_dict.items():
        k = re.sub(r"^module\.", "", k)
        if k.startswith("textmodel."):
            if k.startswith("textmodel.pooler."):
                report.skipped.append(k)
                continue
            k = re.sub(r"LayerNorm\.gamma$", "LayerNorm.weight", k)
            k = re.sub(r"LayerNorm\.beta$", "LayerNorm.bias", k)
        if k not in own:
            report.unmatched.append(k)
            continue
        if tuple(np.shape(v)) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(own[k].shape)} vs "
                             f"{tuple(np.shape(v))}")
        out[k] = v
        if not k.endswith("num_batches_tracked"):
            report.matched.append(k)
    for k, v in own.items():
        if k not in out:
            out[k] = v
            if not k.endswith("num_batches_tracked"):
                report.untouched.append(k)
    if strict and report.unmatched:
        raise KeyError(f"{len(report.unmatched)} reference keys have no mapping "
                       f"(first: {report.unmatched[:5]}); pass strict=False to ignore")
    missing = [k for k in report.untouched if not k.startswith("textmodel.proj.")]
    if strict and missing:
        raise KeyError(f"the reference state_dict lacks {len(missing)} keys of the "
                       f"model (first: {missing[:5]}); pass strict=False to ignore")
    if not report.matched:
        raise ValueError("no reference keys matched")
    return out, report


def export_reference_state_dict(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's state_dict as numpy arrays in the reference namespace
    (without the BatchNorm counters): what the reference code loads."""
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def load_reference_checkpoint(path: str, model: nn.Module,
                              strict: bool = True) -> ConversionReport:
    """Load a reference `.pth.tar` (a bare state_dict or the {epoch,
    state_dict, best_loss, optimizer} wrapper) into `model`."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    converted, report = convert_reference_state_dict(sd, model, strict=strict)
    load_into(model, converted)
    return report
