"""What the reference computes for each kind of traffic: the answers of a
served tick, of an offline eval call and of the first training steps,
with the tables the comparison reads. Plain PyTorch over the model of
`reference.model`; imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench.reference import model as M
from portbench.reference.geometry import Geometry


def _features(W, g: Geometry, frames: torch.Tensor, P: M.Prec, block: int) -> List[torch.Tensor]:
    """Mapped features of (N, H, W, 3) frames, `block` frames at a time."""
    parts = [M.mapped_features(W, g, frames[i:i + block], False, P)
             for i in range(0, frames.shape[0], block)]
    return [torch.cat([p[s] for p in parts]) for s in range(3)]


@torch.no_grad()
def serve(W, g: Geometry, history: torch.Tensor, ids: torch.Tensor, seen: torch.Tensor,
          topk: int, P: M.Prec = M.FP32, block: int = 36) -> Dict[str, torch.Tensor]:
    """The serving engine's tick for S sampled (stream, tick) pairs.

    history (S, 2 n - 1, H, W, 3): the stream's frames of ticks t - 2n + 2
    .. t (n = n_frames_test); ids (S, L); seen (S,): frames the stream had
    seen after tick t. Tick t's ring holds its last n frames; its
    prediction is for the ring's center; the top-k cache keeps the last n
    ticks' top-k (box, score, feature), fused around the cache's center.
    Returns the answers (raw_box, raw_score, fused_box) and the tables the
    comparison reads: candidates at t (cand_boxes, cand_conf) and at the
    cache's center (ctr_boxes, ctr_conf, fused_all, fused_best, conf_kth)."""
    s, hist = history.shape[:2]
    n = g.n_frames_test
    feats = _features(W, g, history.reshape(s * hist, *history.shape[2:]).float(), P, block)
    feats = [f.reshape(s, hist, *f.shape[1:]) for f in feats]
    lang = M.language(W, g, ids, False, P)
    ticks = []
    for end in range(n - 1, hist):                    # ticks t - n + 1 .. t
        corr = M.corr_features(W, g, [f[:, end - n + 1:end + 1] for f in feats], P)
        tr = M.trunk(W, g, corr, lang, ids, False, P)
        cand = M.candidates(g, tr.outbox)
        top = M.topk_order(cand.conf, topk)
        ticks.append((cand, corr, top))
    cand_t = ticks[-1][0]
    best = cand_t.conf.argmax(dim=1)
    rows = torch.arange(s, device=history.device)
    c = n // 2
    ctr, ctr_corr, ctr_top = ticks[c]
    win_feats = torch.stack([M.candidate_feats(cd, cr, tp) for cd, cr, tp in ticks], 1)
    win_scores = torch.stack([torch.gather(cd.conf, 1, tp) for cd, _, tp in ticks], 1)
    age = torch.arange(n - 1, -1, -1, device=history.device)
    valid = seen[:, None] > age[None]
    all_idx = torch.arange(ctr.conf.shape[1], device=history.device).expand(s, -1)
    fused_all = M.fused_scores(M.candidate_feats(ctr, ctr_corr, all_idx), win_feats,
                               win_scores, valid)
    fused_top = torch.gather(fused_all, 1, ctr_top)
    pick = ctr_top[rows, fused_top.argmax(dim=1)]
    return {"raw_box": cand_t.boxes[rows, best], "raw_score": cand_t.conf[rows, best],
            "fused_box": ctr.boxes[rows, pick],
            "cand_boxes": cand_t.boxes, "cand_conf": cand_t.conf,
            "ctr_boxes": ctr.boxes, "ctr_conf": ctr.conf, "fused_all": fused_all,
            "fused_best": fused_top.max(dim=1).values,
            "conf_kth": torch.gather(ctr.conf, 1, ctr_top[:, -1:])[:, 0]}


@torch.no_grad()
def evaluate(W, g: Geometry, clips: torch.Tensor, ids: torch.Tensor, P: M.Prec = M.FP32,
             block: int = 40) -> Dict[str, torch.Tensor]:
    """The offline eval of S clips (S, n, H, W, 3) with their phrases (S, L):
    the center frame's argmax answer (index, box, score) and the
    candidates."""
    s, n = clips.shape[:2]
    feats = _features(W, g, clips.reshape(s * n, *clips.shape[2:]).float(), P, block)
    corr = M.corr_features(W, g, [f.reshape(s, n, *f.shape[1:]) for f in feats], P)
    tr = M.trunk(W, g, corr, M.language(W, g, ids, False, P), ids, False, P)
    cand = M.candidates(g, tr.outbox)
    best = cand.conf.argmax(dim=1)
    rows = torch.arange(s, device=clips.device)
    return {"idx": best, "box": cand.boxes[rows, best], "score": cand.conf[rows, best],
            "cand_boxes": cand.boxes, "cand_conf": cand.conf}


def trainable(spec: Sequence[M.Param]) -> List[str]:
    """The leaves an optimizer steps: parameters, not running statistics or
    counters, and not the frozen BERT body."""
    return [p.name for p in spec if p.kind not in ("bn_mean", "bn_var", "count")
            and not M.frozen(p.name)]


def _step(W, sq, names: Sequence[str], g: Geometry, batch: Dict[str, torch.Tensor],
          gen: torch.Generator, P: M.Prec):
    """One training step on `batch`, W and sq updated in place: (the
    total loss, the gradients before decay, as the optimizer took them)."""
    out = M.train_losses(W, g, batch["images"], batch["word_ids"], batch["bbox"], gen, P)
    grads = torch.autograd.grad(out["loss"], [W[n] for n in names], allow_unused=True)
    grads = {n: (torch.zeros_like(W[n]) if gr is None else gr) for n, gr in zip(names, grads)}
    with torch.no_grad():
        taken = M.rmsprop_step(W, sq, grads, g)
    return float(out["loss"].detach()), grads, taken


def train(W, g: Geometry, batches: Sequence[Dict[str, torch.Tensor]], neg_seed: int,
          dropout_seed: int, steps: int = 3, P: M.Prec = M.FP32) -> dict:
    """The first `steps` training steps from the weights W (changed in
    place) on `batches` (images, word_ids, bbox): each step's total loss,
    the first step's gradient norms (before and after the decay the
    optimizer folds in) and the norm of each leaf's change after the
    last step. The contrastive negatives draw from a device generator
    seeded with `neg_seed`; dropout from the device's default generator,
    seeded with `dropout_seed` before the first step."""
    device = batches[0]["images"].device
    names = trainable(M.param_spec(g))
    start = {n: W[n].detach().clone() for n in names}
    for n in names:
        W[n].requires_grad_(True)
    sq = {n: torch.zeros_like(W[n]) for n in names}
    gen = torch.Generator(device=device).manual_seed(neg_seed)
    torch.manual_seed(dropout_seed)
    losses, grad, raw_grad = [], {}, {}
    for i in range(steps):
        loss, grads, taken = _step(W, sq, names, g, batches[i], gen, P)
        losses.append(loss)
        if i == 0:
            grad = {n: float(taken[n].norm()) for n in names}
            raw_grad = {n: float(grads[n].norm()) for n in names}
    with torch.no_grad():
        change = {n: float((W[n] - start[n]).norm()) for n in names}
    for n in names:
        W[n].requires_grad_(False)
    return {"losses": losses, "grad": grad, "raw_grad": raw_grad, "change": change}


def train_step_from(W, sq: Dict[str, torch.Tensor], g: Geometry,
                    batch: Dict[str, torch.Tensor], neg_state: torch.Tensor,
                    rng_state: torch.Tensor, P: M.Prec = M.FP32) -> dict:
    """One training step from a given state: the weights W and RMSprop's
    square averages sq (both changed in place), the negatives' generator
    state and the device's default generator state (dropout). Returns the
    step's total loss (`step_loss`), each leaf's change norm
    (`step_change`) and gradient norm before decay (`step_raw_grad`)."""
    device = batch["images"].device
    names = trainable(M.param_spec(g))
    start = {n: W[n].detach().clone() for n in names}
    for n in names:
        W[n].requires_grad_(True)
    gen = torch.Generator(device=device)
    gen.set_state(neg_state)
    if device.type == "cuda":
        torch.cuda.set_rng_state(rng_state, device)
    else:
        torch.set_rng_state(rng_state)
    loss, grads, _ = _step(W, sq, names, g, batch, gen, P)
    with torch.no_grad():
        change = {n: float((W[n] - start[n]).norm()) for n in names}
    for n in names:
        W[n].requires_grad_(False)
    return {"step_loss": loss, "step_change": change,
            "step_raw_grad": {n: float(grads[n].norm()) for n in names}}
