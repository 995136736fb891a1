"""The port's YOLOv3 detection decode and target building
(`dcnet_tpu_torch/ops/yolo_detect.py`) against the JAX package's on the
same seeded inputs: detections within rtol 1e-6 / atol 1e-6 (NCHW and
NHWC heads); the masks, tconf and tcls equal and txywh within 1e-6, with
padded object lists and two objects in one cell and anchor (the later
one's write kept, as the JAX package's scatter keeps it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnet_tpu.ops import yolo_detect as jyolo
from dcnet_tpu_torch.ops import yolo_detect as pyolo

ANCHORS = [(116, 90), (156, 198), (373, 326)]
GRID_ANCHORS = [(1.5, 2.0), (3.0, 3.0), (5.0, 4.0)]


def test_category_map_equals_jax():
    assert pyolo.EXIST_ID == jyolo.EXIST_ID
    assert pyolo.coco_category_map() == jyolo.coco_category_map()


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("g,classes,img_dim", [(4, 80, 256), (13, 3, 416)])
def test_yolo_detections_match_jax(layout, g, classes, img_dim):
    rng = np.random.RandomState(2)
    a = len(ANCHORS)
    shape = (2, a * (5 + classes), g, g) if layout == "nchw" else (2, g, g, a * (5 + classes))
    head = rng.randn(*shape).astype(np.float32)
    want = np.asarray(jyolo.yolo_detections(jnp.asarray(head), ANCHORS, classes, img_dim))
    got = pyolo.yolo_detections(torch.from_numpy(head), ANCHORS, classes, img_dim)
    assert got.shape == (2, a * g * g, 5 + classes) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _targets(rng, b, t, filled):
    targets = np.zeros((b, t, 5), np.float32)
    for i, n in enumerate(filled):
        targets[i, :n, 0] = rng.randint(0, 80, n)
        targets[i, :n, 1:3] = rng.uniform(0.02, 0.98, (n, 2))
        targets[i, :n, 3:] = rng.uniform(0.05, 0.6, (n, 2))
    return targets


@pytest.mark.parametrize("g,filled", [(8, (2, 1, 0)), (13, (5, 3, 4))])
def test_build_object_targets_match_jax(g, filled):
    rng = np.random.RandomState(3)
    targets = _targets(rng, len(filled), 6, filled)
    # a second object in the first object's cell, at the same anchor
    targets[0, 1] = targets[0, 0] + np.array([7, 0.001, 0.001, 0.002, 0.001], np.float32)
    # an object whose IoU passes the ignore threshold at two anchors
    targets[1, 0, 3:] = np.array([3.8, 3.5], np.float32) / g
    want = jyolo.build_object_targets(jnp.asarray(targets), GRID_ANCHORS, g)
    got = pyolo.build_object_targets(torch.from_numpy(targets), GRID_ANCHORS, g)
    for name in ("mask", "conf_mask", "tconf", "tcls"):
        w, o = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert o.dtype == w.dtype and np.array_equal(o, w), name
    np.testing.assert_allclose(got.txywh.numpy(), np.asarray(want.txywh), rtol=0, atol=1e-6)
    assert got.mask.sum() >= 1 and (got.conf_mask == 0).any()
