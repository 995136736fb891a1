"""YOLO box decoding: the port of `dcnet_tpu/ops/decode.py`.

Flat argmax over the concatenated per-scale conf maps (ties go to the first
occurrence, as in JAX), scale selection by index range, then
box = (sigmoid(tx)+gi, sigmoid(ty)+gj, exp(tw)*aw, exp(th)*ah) * stride.
Top-k keeps JAX's tie order (lower index first) through a stable sort.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.ops.boxes import xywh2xyxy


class DecodedBoxes(NamedTuple):
    boxes: torch.Tensor   # (B, K, 4) xyxy in letterboxed pixel coords
    score: torch.Tensor   # (B, K) conf value at the decoded slot
    best_n: torch.Tensor  # (B, K) global anchor index (scale*3 + anchor)
    scale: torch.Tensor   # (B, K)
    gi: torch.Tensor      # (B, K)
    gj: torch.Tensor      # (B, K)


def flatten_conf(outbox: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-scale (B, 3, 5, g, g) -> (B, 3*sum(g^2)) conf vector, per scale
    anchor-major then row then column."""
    b = outbox[0].shape[0]
    return torch.cat([o[:, :, 4].reshape(b, -1) for o in outbox], dim=1)


def decode_indices(outbox: Sequence[torch.Tensor], flat_idx: torch.Tensor,
                   cfg: DCNetConfig) -> DecodedBoxes:
    """Decode boxes at flat conf indices. flat_idx: (B, K) integer."""
    offs, strides, grids = cfg.scale_offsets(), cfg.strides, cfg.grids
    b, k = flat_idx.shape
    dev = flat_idx.device
    flat_idx = flat_idx.long()
    rows = torch.arange(b, device=dev)[:, None]
    boxes = torch.zeros((b, k, 4), device=dev)
    score = torch.zeros((b, k), device=dev)
    best_n = torch.zeros((b, k), dtype=torch.int32, device=dev)
    scale = torch.zeros_like(best_n)
    gi_out = torch.zeros_like(best_n)
    gj_out = torch.zeros_like(best_n)
    for s, o in enumerate(outbox):
        g = grids[s]
        local = flat_idx - offs[s]
        valid = (local >= 0) & (local < 3 * g * g)
        local = torch.clamp(local, 0, 3 * g * g - 1)
        anchor = local // (g * g)
        rem = local % (g * g)
        gj, gi = rem // g, rem % g
        picked = o.reshape(b, 3, 5, g * g)[rows, anchor, :, rem].float()  # (B, K, 5)
        anchors_s = torch.tensor(cfg.scaled_anchors(s), dtype=torch.float32,
                                 device=dev)
        aw, ah = anchors_s[anchor, 0], anchors_s[anchor, 1]
        cx = (torch.sigmoid(picked[..., 0]) + gi) * strides[s]
        cy = (torch.sigmoid(picked[..., 1]) + gj) * strides[s]
        bw = torch.exp(picked[..., 2]) * aw * strides[s]
        bh = torch.exp(picked[..., 3]) * ah * strides[s]
        cand = xywh2xyxy(torch.stack([cx, cy, bw, bh], dim=-1))
        boxes = torch.where(valid[..., None], cand, boxes)
        score = torch.where(valid, picked[..., 4], score)
        best_n = torch.where(valid, (s * 3 + anchor).int(), best_n)
        scale = torch.where(valid, torch.full_like(scale, s), scale)
        gj_out = torch.where(valid, gj.int(), gj_out)
        gi_out = torch.where(valid, gi.int(), gi_out)
    return DecodedBoxes(boxes, score, best_n, scale, gi_out, gj_out)


def decode_best(outbox: Sequence[torch.Tensor], cfg: DCNetConfig) -> DecodedBoxes:
    """Argmax decode (the validate/test path)."""
    idx = torch.argmax(flatten_conf(outbox), dim=1)[:, None]
    return decode_indices(outbox, idx, cfg)


def decode_topk(outbox: Sequence[torch.Tensor], k: int,
                cfg: DCNetConfig) -> DecodedBoxes:
    """Top-k decode for the temporal cache writer."""
    order = torch.sort(flatten_conf(outbox), dim=1, descending=True,
                       stable=True).indices
    return decode_indices(outbox, order[:, :k], cfg)


def inverse_letterbox(boxes: torch.Tensor, ratio, dw, dh, orig_w, orig_h
                      ) -> torch.Tensor:
    """Map letterboxed-pixel xyxy boxes back to original image coords:
    subtract the padding, divide by the ratio, clamp to the image. The
    geometry arguments broadcast against boxes[..., 0]."""
    ratio, dw, dh, orig_w, orig_h = (
        torch.as_tensor(v, dtype=boxes.dtype, device=boxes.device)
        for v in (ratio, dw, dh, orig_w, orig_h))
    x1 = torch.clamp((boxes[..., 0] - dw) / ratio, min=0)
    y1 = torch.clamp((boxes[..., 1] - dh) / ratio, min=0)
    x2 = torch.minimum((boxes[..., 2] - dw) / ratio, orig_w)
    y2 = torch.minimum((boxes[..., 3] - dh) / ratio, orig_h)
    return torch.stack([x1, y1, x2, y2], dim=-1)
