"""Temporal cache + cross-frame score fusion: the port of
`dcnet_tpu/eval/temporal.py`.

- `build_frame_cache`: per frame, the top-k conf peaks -> boxes, scores and
  the fused correspondence feature at each peak (the serving engine builds
  one row per stream per tick).
- `temporal_fuse`: for each frame, the similarity of its top-k features to
  the top-k features of the +-floor(k/2) neighbour frames, max-pooled over
  the neighbour candidates, softmaxed over frames, invalid frames zeroed;
  fused score = sum(softmax(sim) * neighbour score), argmax box.
- `fuse_per_video`: the same over a multi-video cache, never across video
  boundaries.

Ties in the argmaxes keep the first index, as `jnp.argmax` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.ops.decode import decode_topk


class FrameCache(NamedTuple):
    """Per-frame top-k grounding cache for one video (T frames)."""

    boxes: torch.Tensor   # (T, K, 4) xyxy, letterboxed coords
    scores: torch.Tensor  # (T, K)
    feats: torch.Tensor   # (T, K, C) fused feature at each peak cell


def build_frame_cache(outbox: Sequence[torch.Tensor],
                      corr_feat: Sequence[torch.Tensor], k: int,
                      cfg: DCNetConfig) -> FrameCache:
    """From a batch of per-frame model outputs (the batch read as T
    frames): top-k decode + feature gather. The features start as fp32
    zeros and each scale's gathered values replace them where the peak lies
    on that scale, so the cache leaves here in fp32."""
    dec = decode_topk(outbox, k, cfg)
    t = dec.boxes.shape[0]
    c = corr_feat[0].shape[-1]
    feats = torch.zeros((t, k, c), dtype=torch.float32, device=dec.boxes.device)
    for s, f in enumerate(corr_feat):
        g = f.shape[1]
        flat = f.reshape(t, g * g, c)
        cell = (torch.clamp(dec.gj, 0, g - 1) * g
                + torch.clamp(dec.gi, 0, g - 1)).long()
        vals = torch.gather(flat, 1, cell[..., None].expand(t, k, c))
        feats = torch.where((dec.scale == s)[..., None], vals, feats)
    return FrameCache(boxes=dec.boxes, scores=dec.score, feats=feats)


def temporal_fuse(cache: FrameCache, ref_frames: int,
                  t_valid: Optional[int] = None) -> torch.Tensor:
    """Fuse each frame's top-k scores with its temporal neighbourhood and
    pick the winning box. Returns (T, 4) boxes.

    Neighbour indices that fall off the ends are clamped into the cache and
    their weight is zeroed after the softmax. `t_valid` marks the real
    frame count when the cache is padded (`fuse_per_video`); rows at or
    past it produce boxes the caller discards."""
    t, k, _ = cache.feats.shape
    dev = cache.feats.device
    t_real = t if t_valid is None else t_valid
    half = ref_frames // 2
    offsets = torch.arange(-half, half + 1, device=dev)           # (R,)
    frame_idx = torch.arange(t, device=dev)[:, None] + offsets[None, :]
    valid = (frame_idx >= 0) & (frame_idx < t_real)              # (T, R)
    frame_idx = torch.clamp(frame_idx, 0, t - 1)

    neigh_feats = cache.feats[frame_idx]      # (T, R, K, C)
    neigh_scores = cache.scores[frame_idx]    # (T, R, K)
    # sim[t, i, r, j] = <feat_t_i, feat_{t+r}_j>
    sim = torch.einsum("tic,trjc->tirj", cache.feats, neigh_feats)
    sim_max = sim.max(dim=3).values                               # (T, K, R)
    best_j = torch.argmax(sim, dim=3)                             # (T, K, R)
    r_count = offsets.shape[0]
    ref_score = torch.gather(
        neigh_scores[:, None].expand(t, k, r_count, k), 3,
        best_j[..., None])[..., 0]                                # (T, K, R)
    w = torch.softmax(sim_max, dim=2) * valid[:, None, :]
    fused = torch.sum(w * ref_score, dim=2)                       # (T, K)
    best = torch.argmax(fused, dim=1)                             # (T,)
    return cache.boxes[torch.arange(t, device=dev), best]


def fuse_per_video(cache: FrameCache, video_ids, ref_frames: int) -> torch.Tensor:
    """Temporal fusion over a multi-video cache, respecting video
    boundaries: a neighbour outside the row's video is missing and its
    weight zeroed. `video_ids` gives each cache row's video; each video's
    rows are padded to the longest video's count and fused with t_valid set
    to their own count, as the JAX package's vmapped pass does. Returns
    (T, 4) fused boxes in the original row order."""
    video_ids = np.asarray(video_ids.cpu() if torch.is_tensor(video_ids)
                           else video_ids)
    uids = list(dict.fromkeys(video_ids.tolist()))
    groups = [np.nonzero(video_ids == u)[0] for u in uids]
    tmax = max(len(g) for g in groups)
    out = torch.zeros((len(video_ids), 4), dtype=torch.float32,
                      device=cache.boxes.device)

    def pad(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        x = x[rows]
        return torch.cat([x, x.new_zeros((tmax - len(rows), *x.shape[1:]))])

    for g in groups:
        rows = torch.as_tensor(g, device=cache.boxes.device)
        padded = FrameCache(*(pad(x, rows) for x in cache))
        out[rows] = temporal_fuse(padded, ref_frames, t_valid=len(g))[:len(g)].float()
    return out
