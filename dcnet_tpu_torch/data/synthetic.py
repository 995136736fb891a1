"""Synthetic grounding data for tests and data-free runs: the port of
`dcnet_tpu/data/synthetic.py`.

Procedural "videos" (a coloured rectangle moving over a noise background,
with a phrase naming its size, colour and direction) in the nested index
format of `VID_video_level_{split}`, so the dataset pipeline (decode ->
letterbox -> tokenize) runs end to end. The same seed gives the JAX
package's index and pixels. Frames are written as `.jpg` (cv2's encoder,
the JAX package's files) or as `.npy` (the rendered uint8 RGB array,
lossless, numpy only).
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

from dcnet_tpu_torch.data.corpus import Corpus

COLORS = {
    "red": (200, 40, 40), "green": (40, 180, 60), "blue": (40, 70, 200),
    "yellow": (220, 200, 40), "purple": (150, 60, 180),
}
SIZES = {"small": 30, "large": 70}
FRAME_FORMATS = ("jpg", "npy")


def synthetic_phrases() -> List[str]:
    return [f"the {s} {c} box moving {d}"
            for s in SIZES for c in COLORS for d in ("left", "right")]


def build_synthetic_corpus() -> Corpus:
    return Corpus.build(synthetic_phrases())


def _render_frame(rng: np.random.Generator, h: int, w: int,
                  color: Tuple[int, int, int], cx: float, cy: float,
                  side: int) -> Tuple[np.ndarray, np.ndarray]:
    img = (rng.integers(0, 80, (h, w, 3))).astype(np.uint8)
    x1 = int(np.clip(cx - side / 2, 0, w - 2))
    y1 = int(np.clip(cy - side / 2, 0, h - 2))
    x2 = int(np.clip(cx + side / 2, x1 + 1, w - 1))
    y2 = int(np.clip(cy + side / 2, y1 + 1, h - 1))
    img[y1:y2, x1:x2] = np.asarray(color, np.uint8)
    return img, np.asarray([x1, y1, x2, y2], np.float64)


def _jpeg_writer():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "writing .jpg frames needs cv2 (OpenCV), which is not installed; "
            "write .npy frames instead (frame_format='npy')") from e

    def write(path: str, img: np.ndarray) -> None:
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return write


def generate_synthetic_vid(
    root: str, split: str = "train", num_videos: int = 4,
    frames_per_video: int = 6, height: int = 320, width: int = 480,
    seed: int = 0, frame_format: str = "jpg",
) -> str:
    """Write frames + a JSON index under `root`. Returns the index path.

    Train index nesting: [video][track][frame]; test: [video][frame].
    """
    if frame_format not in FRAME_FORMATS:
        raise ValueError(f"frame_format must be one of {FRAME_FORMATS}")
    write = _jpeg_writer() if frame_format == "jpg" else np.save
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "frames"), exist_ok=True)
    colors = list(COLORS)
    videos = []
    for v in range(num_videos):
        color_name = colors[int(rng.integers(len(colors)))]
        size_name = "small" if rng.random() < 0.5 else "large"
        direction = "left" if rng.random() < 0.5 else "right"
        phrase = f"the {size_name} {color_name} box moving {direction}"
        side = SIZES[size_name]
        cx = rng.uniform(side, width - side)
        cy = rng.uniform(side, height - side)
        vx = (-1 if direction == "left" else 1) * rng.uniform(5, 15)
        track = []
        for f in range(frames_per_video):
            img, bbox = _render_frame(
                rng, height, width, COLORS[color_name], cx, cy, side)
            rel = os.path.join("frames", f"v{v:03d}_f{f:03d}.{frame_format}")
            write(os.path.join(root, rel), img)
            track.append([rel, bbox.tolist(), phrase])
            cx = float(np.clip(cx + vx, side / 2, width - side / 2))
            cy = float(np.clip(cy + rng.uniform(-3, 3), side / 2,
                               height - side / 2))
        videos.append([track] if split == "train" else track)

    index_path = os.path.join(root, f"VID_video_level_{split}.json")
    with open(index_path, "w") as f:
        json.dump(videos, f)
    return index_path
