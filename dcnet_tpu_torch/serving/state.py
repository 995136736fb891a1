"""The streaming engine's state, on its own: no model code.

`StreamState` holds every stream's feature rings and top-k caches. The
engine (`serving/engine.py`) makes and advances it; the exported runtime
(`serving/export.py`) advances it without importing any model module.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class StreamState(NamedTuple):
    """Rings and caches of all streams. Leading dim = n_streams."""

    feat_rings: Tuple[torch.Tensor, ...]  # per scale (N, n_frame, g, g, C)
    cache_boxes: torch.Tensor             # (N, fuse_window, K, 4) fp32
    cache_scores: torch.Tensor            # (N, fuse_window, K) fp32
    cache_feats: torch.Tensor             # (N, fuse_window, K, C)
    frames_seen: torch.Tensor             # (N,) int32
    word_ids: torch.Tensor                # (N, L) each stream's phrase
    language: Tuple[torch.Tensor, ...]    # cached (flang, context, embedded)
    slot: int  # physical ring index of the newest frame (rotate mode);
    #            carried but unused in shift mode
