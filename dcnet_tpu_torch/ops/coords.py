"""Normalised 8-channel coordinate embedding.

The port of `dcnet_tpu/ops/coords.py`, copied exactly, including the
original's transposed naming: the row channels are normalised by the width
and the column channels by the height. Channels: [row_min, col_min,
row_max, col_max, row_ctr, col_ctr, 1/H, 1/W].
"""

from __future__ import annotations

import torch


def generate_coord(height: int, width: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Returns (8, H, W); broadcast over the batch at the call site."""
    rows = torch.arange(height, device=device).to(dtype)[:, None].expand(height, width)
    cols = torch.arange(width, device=device).to(dtype)[None, :].expand(height, width)
    r_min = (rows * 2 - width) / width
    c_min = (cols * 2 - height) / height
    r_max = ((rows + 1) * 2 - width) / width
    c_max = ((cols + 1) * 2 - height) / height
    r_ctr = (r_min + r_max) / 2
    c_ctr = (c_min + c_max) / 2
    hmap = torch.full((height, width), 1.0 / height, dtype=dtype, device=device)
    wmap = torch.full((height, width), 1.0 / width, dtype=dtype, device=device)
    return torch.stack([r_min, c_min, r_max, c_max, r_ctr, c_ctr, hmap, wmap])
