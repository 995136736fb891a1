"""The benchmark's inputs, drawn from the seed on the device: video frames,
phrases (BiLSTM corpus ids or BERT word pieces) and the synthetic training
clips. Every seed draws the same sizes; only the values differ.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import torch

# BERT's special ids in bert-base-uncased's vocabulary
CLS, SEP = 101, 102
FIRST_WORD_PIECE = 1996   # ids below are [unused], special and single characters


def sub_seed(seed: int, tag: str) -> int:
    """An independent 63-bit seed for one use of the run's seed."""
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


SCALES = ((4, 1.0), (16, 0.5), (64, 0.25))   # (cells a side, amplitude) of the fields
GRAIN = 0.1                                    # amplitude of the pixel noise
MAX_SHIFT = 4                                  # pixels a frame the view moves, at most


def video(gen: torch.Generator, streams: int, frames: int, size: int, device) -> torch.Tensor:
    """(frames, streams, size, size, 3) float32 in [0, 1]: each stream a
    view moving over its own scene at a constant speed (0..MAX_SHIFT pixels
    a frame on each axis). A scene is a sum of random colour fields at a
    few scales (bilinearly upsampled) plus pixel noise, so that features
    vary from place to place at every depth of the backbone, as in real
    video; i.i.d. pixel noise alone averages out to a constant deep in the
    network."""
    import torch.nn.functional as F

    span = size + MAX_SHIFT * (frames - 1)
    scene = GRAIN * torch.rand((streams, 3, span, span), generator=gen, device=device)
    for cells, amp in SCALES:
        coarse = torch.rand((streams, 3, cells, cells), generator=gen, device=device)
        scene += amp * F.interpolate(coarse, size=(span, span), mode="bilinear",
                                     align_corners=False)
    scene /= GRAIN + sum(a for _, a in SCALES)
    speed = torch.randint(0, MAX_SHIFT + 1, (streams, 2), generator=gen, device=device).tolist()
    out = torch.empty((frames, streams, size, size, 3), device=device)
    for s, (vy, vx) in enumerate(speed):
        for t in range(frames):
            out[t, s] = scene[s, :, vy * t:vy * t + size, vx * t:vx * t + size].permute(1, 2, 0)
    return out


def frames(gen: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """(n, size, size, 3): n unrelated views, one frame each of `video`."""
    return video(gen, n, 1, size, device)[0]


def clips(gen: torch.Generator, n: int, length: int, size: int, device) -> torch.Tensor:
    """(n * length, size, size, 3): n clips of `length` consecutive frames
    of `video`, the frames of a clip adjacent."""
    return video(gen, n, length, size, device).transpose(0, 1).reshape(
        n * length, size, size, 3)


def corpus_phrases(gen: torch.Generator, n: int, length: int, vocab: int,
                   min_words: int, max_words: int, device) -> torch.Tensor:
    """(n, length) ids in [1, vocab), each phrase min_words..max_words long,
    zero-padded."""
    words = torch.randint(min_words, max_words + 1, (n, 1), generator=gen, device=device)
    ids = torch.randint(1, vocab, (n, length), generator=gen, device=device)
    return torch.where(torch.arange(length, device=device)[None] < words, ids, 0)


def bert_phrases(gen: torch.Generator, n: int, length: int, vocab: int,
                 min_pieces: int, max_pieces: int, device) -> torch.Tensor:
    """(n, length): [CLS], min..max word pieces, [SEP], zero padding."""
    pieces = torch.randint(min_pieces, max_pieces + 1, (n, 1), generator=gen, device=device)
    ids = torch.randint(FIRST_WORD_PIECE, vocab, (n, length), generator=gen, device=device)
    pos = torch.arange(length, device=device)[None]
    ids = torch.where(pos <= pieces, ids, 0)
    ids = torch.where(pos == pieces + 1, SEP, ids)
    ids[:, 0] = CLS
    return ids


COLORS = torch.tensor([[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0],
                       [255, 0, 255], [0, 255, 255]], dtype=torch.float32)


def synthetic_clips(gen: torch.Generator, clips: int, k: int, size: int, length: int,
                    vocab: int, device) -> Dict[str, torch.Tensor]:
    """k-frame clips of a coloured box moving sideways over dark noise, as
    the repository's synthetic set draws them: images (clips * k, size,
    size, 3) in [0, 1], frames of a clip adjacent; bbox (clips * k, 4)
    xyxy pixels; word_ids (clips * k, length), a six-word phrase per clip
    ("the <size> <color> box moving <direction>") over fixed corpus ids."""
    n = clips * k
    noise = torch.randint(0, 80, (n, size, size, 3), generator=gen, device=device).float()
    color = torch.randint(0, len(COLORS), (clips,), generator=gen, device=device)
    large = torch.rand(clips, generator=gen, device=device) < 0.5
    right = torch.rand(clips, generator=gen, device=device) < 0.5
    side = torch.where(large, size * 0.3, size * 0.15)
    u = torch.rand((clips, 2), generator=gen, device=device)
    cx0 = side + u[:, 0] * (size - 2 * side)
    cy = side + u[:, 1] * (size - 2 * side)
    vx = torch.where(right, 1.0, -1.0) * (5 + 10 * torch.rand(clips, generator=gen,
                                                              device=device))
    f = torch.arange(k, device=device)
    cx = (cx0[:, None] + vx[:, None] * f[None]).reshape(n)
    cy, side = cy.repeat_interleave(k), side.repeat_interleave(k)
    x1 = torch.clamp(cx - side / 2, 0, size - 2).floor()
    y1 = torch.clamp(cy - side / 2, 0, size - 2).floor()
    x2 = torch.maximum(torch.clamp(cx + side / 2, 0, size - 1).floor(), x1 + 1)
    y2 = torch.maximum(torch.clamp(cy + side / 2, 0, size - 1).floor(), y1 + 1)
    pix = torch.arange(size, device=device, dtype=torch.float32)
    inside = ((pix[None, :, None] >= y1[:, None, None]) & (pix[None, :, None] < y2[:, None, None])
              & (pix[None, None, :] >= x1[:, None, None]) & (pix[None, None, :] < x2[:, None, None]))
    col = COLORS.to(device)[color].repeat_interleave(k, 0)
    images = torch.where(inside[..., None], col[:, None, None, :], noise) / 255.0
    # "the", small/large, six colours, "box", "moving", left/right: ids 1..13
    words = torch.stack([torch.full_like(color, 1), 2 + large.long(), 4 + color,
                         torch.full_like(color, 10), torch.full_like(color, 11),
                         12 + right.long()], 1)
    words = torch.remainder(words - 1, vocab - 1) + 1
    ids = torch.zeros((clips, length), dtype=torch.long, device=device)
    ids[:, :6] = words
    return {"images": images.contiguous(), "bbox": torch.stack([x1, y1, x2, y2], 1),
            "word_ids": ids.repeat_interleave(k, 0)}
