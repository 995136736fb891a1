"""The comparisons that decide `correct`, and the limits they are held to.

Detection answers (a box and its score) are judged as a served token is
judged against a reference's logits: the answer is matched to the
reference's candidate it names (its anchor index where the program gives
one, else the candidate whose box lies nearest), and three numbers are
read over the sampled answers:

- `box_rel`, the widest: the distance (largest coordinate gap) of an
  answer's box from its matched candidate's reference box, over that
  box's longer side;
- `score_rel`, the widest: the gap of an answer's score from its
  candidate's reference confidence, over the larger of that confidence's
  magnitude and the map's standard deviation;
- `choice_gap_mean`, the mean: how far the matched candidate's reference
  confidence lies below the reference's best, in units of the reference
  confidence map's standard deviation (for a fused box: its fused score
  below the reference's fused best, or its confidence below the
  reference's k-th, whichever is larger). The mean, because the top of
  the map is dense: a near tie that rounding flips reads a small gap on a
  few answers, a decode or a fusion that chooses wrongly reads a gap on
  every answer.

Training is judged by its losses, its first gradient and its parameters'
change, each as the worst leaf's gap of norms (see `train_gaps`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

LIMITS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "limits")


def limits_for(workload: str) -> Dict[str, float]:
    """The cell's limits (portbench/limits/<workload>.json, number -> limit)."""
    with open(os.path.join(LIMITS_DIR, f"{workload}.json")) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def nearest(boxes: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Index of the candidate box nearest `box` by largest coordinate gap:
    boxes (S, A, 4), box (S, 4) -> (S,)."""
    return (boxes - box[:, None]).abs().amax(dim=-1).argmin(dim=1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[s, idx[s]] for each sample s."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def box_gap(box: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Largest coordinate gap over the reference box's longer side."""
    side = torch.maximum(ref[:, 2] - ref[:, 0], ref[:, 3] - ref[:, 1]).abs()
    return (box - ref).abs().amax(dim=-1) / torch.clamp(side, min=1.0)


def raw_gaps(box: torch.Tensor, score: torch.Tensor, cand_boxes: torch.Tensor,
             cand_conf: torch.Tensor, idx: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
    """Per sample (S,): an argmax answer (box (S, 4), score (S,)) against
    the reference's candidates (boxes (S, A, 4), conf (S, A))."""
    if idx is None:
        idx = nearest(cand_boxes, box)
    scale = cand_conf.std(dim=1)
    ref = _take(cand_conf, idx)
    return {"box_rel": box_gap(box, _take(cand_boxes, idx)),
            "choice_gap": (cand_conf.max(dim=1).values - ref) / scale,
            "score_rel": (score - ref).abs() / torch.maximum(ref.abs(), scale)}


def fused_gaps(box: torch.Tensor, cand_boxes: torch.Tensor, cand_conf: torch.Tensor,
               fused_all: torch.Tensor, fused_best: torch.Tensor, conf_kth: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """Per sample: a fused answer (box (S, 4)) against the reference's
    candidates at the window's center (boxes, conf (S, A)), their fused
    scores (S, A), the reference's fused best (S,) and its k-th highest
    confidence (S,)."""
    idx = nearest(cand_boxes, box)
    scale = cand_conf.std(dim=1)
    fused_below = (fused_best - _take(fused_all, idx)) / scale
    kth_below = (conf_kth - _take(cand_conf, idx)) / scale
    return {"box_rel": box_gap(box, _take(cand_boxes, idx)),
            "choice_gap": torch.maximum(fused_below, kth_below)}


def detection(*parts: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers compared, over all parts' samples (raw and fused
    answers): the widest `box_rel` and `score_rel`, the mean
    `choice_gap`."""
    def cat(k):
        return torch.cat([p[k].float() for p in parts if k in p])
    return {"box_rel": float(cat("box_rel").max()), "score_rel": float(cat("score_rel").max()),
            "choice_gap_mean": float(cat("choice_gap").mean())}


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    names = list(leaves)
    norms = sorted(ref[n] for n in names)
    median = norms[len(norms) // 2]
    return {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], median, 1e-30) for n in names}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    """The worst leaf's gap of norms, |prog - ref| over the larger of the
    leaf's reference norm and the median leaf's. A leaf the program did
    not report (an optimizer that kept no state for it) reads as 0."""
    return max(_leaf_gap(prog, ref, leaves).values())


def moved(raw_grad: Dict[str, float]):
    """The leaves whose reference gradient is above a thousandth of the
    median leaf's: a gradient that is nought to rounding moves its leaf by
    rounding alone."""
    med = sorted(raw_grad.values())[len(raw_grad) // 2]
    return [n for n in raw_grad if raw_grad[n] > 1e-3 * med]


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """prog / ref: {"losses": [step 1..3 totals], "grad": {leaf: norm of
    the first step's gradient as the optimizer took it}, "change": {leaf:
    norm of the parameters' change after three steps}, "raw_grad": {leaf:
    the reference's first gradient before decay} (ref only), and for the
    window's step: "step_loss", "step_change" ({leaf: norm of that step's
    change}) and "step_raw_grad" (ref only)}.

    - `loss1_rel`: the relative gap of the first step's total loss;
    - `grad_rel`: the worst leaf's gap of first-gradient norms;
    - `change_rel`: the worst moved leaf's gap of change norms after the
      three steps (`moved`);
    - `step_loss_rel`, `step_change_rel`: the same of the window's step,
      which the reference takes from the program's state before it."""
    raw = ref["raw_grad"]
    return {"loss1_rel": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad_rel": leaf_gaps(prog["grad"], ref["grad"], raw),
            "change_rel": leaf_gaps(prog["change"], ref["change"], moved(raw)),
            "step_loss_rel": abs(prog["step_loss"] - ref["step_loss"]) / abs(ref["step_loss"]),
            "step_change_rel": leaf_gaps(prog["step_change"], ref["step_change"],
                                         moved(ref["step_raw_grad"]))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a missing number or a NaN fails)."""
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= v
               for k, v in limits.items())


def summary(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """The numbers compared, each beside its limit."""
    return {k: {"value": numbers.get(k), "limit": v} for k, v in sorted(limits.items())}
