"""Qualitative pictures of grounding results: the port of
`dcnet_tpu/eval/visualize.py`. Denormalizes each image, draws the predicted
(red) and ground-truth (green) boxes and the phrase, and writes JPEGs under
`<save_path>/<mode>/`. Drawing and encoding need cv2, imported here only;
it raises where cv2 is not installed."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from dcnet_tpu_torch.data.transforms import denormalize_image


def save_grounding_results(
    pred_boxes: np.ndarray, gt_boxes: np.ndarray, images: np.ndarray,
    phrases: Sequence[str], mode: str, batch_start_index: int,
    save_path: str = "./visulizations/",
) -> Sequence[str]:
    """images: (N, H, W, 3) normalized NHWC. Returns the written paths."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("save_grounding_results draws and writes JPEGs "
                           "with cv2 (OpenCV), which is not installed") from e

    out_dir = os.path.join(save_path, mode)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for ii in range(images.shape[0]):
        img = denormalize_image(np.asarray(images[ii]))
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
        pb = np.asarray(pred_boxes[ii]).astype(int)
        gb = np.asarray(gt_boxes[ii]).astype(int)
        cv2.rectangle(img, (pb[0], pb[1]), (pb[2], pb[3]), (0, 0, 255), 2)
        cv2.rectangle(img, (gb[0], gb[1]), (gb[2], gb[3]), (0, 255, 0), 2)
        phrase = phrases[min(ii, len(phrases) - 1)] if phrases else ""
        cv2.putText(img, str(phrase), (10, 20), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, (0, 0, 250), 1)
        path = os.path.join(out_dir, f"sample_{batch_start_index + ii}.jpg")
        cv2.imwrite(path, img)
        written.append(path)
    return written
