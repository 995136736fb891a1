"""The port's training augmentations, augmented datasets, auxiliary losses
and `grain_loader` against the JAX package's on the CPU.

The port computes cv2's arithmetic in numpy (cv2 5.0 on x86-64 here):
RGB -> HSV on cv2's integer tables and HSV -> RGB on its float32 path
(FMAs; truncated in its vector blocks of 32 pixels a row, rounded in its
scalar tail) equal cv2 pixel for pixel; so do the flip and HSV jitter
against the JAX transforms. The affine warp equals cv2's matrix and box
exactly; its pixels follow cv2's float32 warp kernel with its FMAs
emulated in float64, which rounds the sum twice: over the seeded cases
below at most one level apart, in at most 1e-4 of the channel values
(2e-5 measured). The augmented datasets are held to the same bound.
"""

import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnet_tpu import losses_extra as jextra
from dcnet_tpu.config import DCNetConfig as JaxConfig
from dcnet_tpu.data import transforms as J
from dcnet_tpu.data.bert_tokenize import FallbackBertTokenizer as JaxTokenizer
from dcnet_tpu.data.referit import ReferItDataset as JaxReferIt
from dcnet_tpu.data.synthetic import build_synthetic_corpus as jax_corpus
from dcnet_tpu.data.synthetic import generate_synthetic_vid
from dcnet_tpu.data.vid import VIDDataset as JaxVID
from dcnet_tpu.data.vid import batch_iterator as jax_batch_iterator
from dcnet_tpu.ops.target import build_target as jax_build_target
from dcnet_tpu_torch import losses_extra as pextra
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.data import transforms as P
from dcnet_tpu_torch.data.bert_tokenize import get_bert_tokenizer
from dcnet_tpu_torch.data.grain_pipeline import grain_loader
from dcnet_tpu_torch.data.referit import ReferItDataset
from dcnet_tpu_torch.data.synthetic import build_synthetic_corpus
from dcnet_tpu_torch.data.vid import VIDDataset
from dcnet_tpu_torch.ops.target import build_target

WARP_LEVELS, WARP_SHARE = 1, 1e-4
SHAPES = [(64, 64, 3), (97, 131, 3), (256, 200, 3), (45, 70, 3)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _warp_close(got, want):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= WARP_LEVELS and (d > 0).mean() <= WARP_SHARE, (d.max(), (d > 0).mean())


def test_hsv_conversions_equal_cv2():
    """Every RGB value to HSV; every HSV value back, in 256-pixel rows (the
    vector blocks) and 1-pixel rows (the scalar tail)."""
    rgb = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(0, 256, 5),
                               indexing="ij"), -1).reshape(-1, 256, 3).astype(np.uint8)
    want = cv2.cvtColor(cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR), cv2.COLOR_BGR2HSV)
    np.testing.assert_array_equal(P.rgb_to_hsv(rgb), want)
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(0, 256, 3),
                               indexing="ij"), -1).reshape(-1, 256, 3).astype(np.uint8)
    for img in (hsv, hsv.reshape(-1, 1, 3), hsv[:, :100]):
        want = cv2.cvtColor(cv2.cvtColor(img, cv2.COLOR_HSV2BGR), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(P.hsv_to_rgb(img), want)


@pytest.mark.parametrize("legacy_hsv", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_hsv_jitter_equals_jax(shape, legacy_hsv):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    for seed in range(4):
        want = J.hsv_jitter(img, np.random.default_rng(seed), legacy_hsv=legacy_hsv)
        got = P.hsv_jitter(img, np.random.default_rng(seed), legacy_hsv=legacy_hsv)
        np.testing.assert_array_equal(got, want)


def test_flip_equals_jax():
    img = np.random.default_rng(0).integers(0, 256, (50, 70, 3), dtype=np.uint8)
    box = np.array([10.0, 20.0, 60.0, 45.0])
    for phrase in ("the left one, right of the car", "a dog"):
        want, got = J.horizontal_flip(img, box, phrase), P.horizontal_flip(img, box, phrase)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


@pytest.mark.parametrize("shape", SHAPES)
def test_random_affine_matches_jax(shape):
    """The same draws give the same matrix, angle and box; the pixels are
    within the warp's bound."""
    rng = np.random.default_rng(shape[0])
    box = np.array([3.0, 5.0, shape[1] * 0.7, shape[0] * 0.8])
    for seed in range(4):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        wi, wb, wm, wa = J.random_affine(img, box, np.random.default_rng(seed))
        gi, gb, gm, ga = P.random_affine(img, box, np.random.default_rng(seed))
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gb, wb)
        assert ga == wa and gi.shape == wi.shape
        _warp_close(gi, wi)
        # a shared transform (M, angle) draws nothing
        r = np.random.default_rng(seed)
        P.random_affine(img, box, r, M=wm, angle=wa)
        assert r.random() == np.random.default_rng(seed).random()


@pytest.fixture(scope="module")
def train_split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("aug"))
    generate_synthetic_vid(root, "train", num_videos=3, frames_per_video=6, seed=5)
    # a ReferIt-style index over the same frames: (img, bbox, phrase)
    with open(os.path.join(root, "VID_video_level_train.json")) as f:
        videos = json.load(f)
    entries = [fr for vid in videos for track in vid for fr in track][:6]
    with open(os.path.join(root, "referit_train.json"), "w") as f:
        json.dump(entries, f)
    return root


def _item_close(got, want, keys):
    for k in keys:
        if k == "images":
            step = 1.0 / (255 * P.IMAGENET_STD.min())
            d = np.abs(got[k].astype(np.float64) - want[k])
            assert d.max() <= WARP_LEVELS * step + 1e-5 and (d > 1e-5).mean() <= WARP_SHARE
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("bert", [False, True], ids=["corpus", "bert"])
def test_augmented_vid_items_match_jax(train_split, bert):
    kw = dict(split="train", imsize=64, num_frame_k=2, max_query_len=20,
              image_root=train_split, seed=7)
    index = os.path.join(train_split, "VID_video_level_train.json")
    jds = JaxVID(index, None if bert else jax_corpus(),
                 bert_tokenizer=JaxTokenizer() if bert else None, **kw)
    pds = VIDDataset(index, None if bert else build_synthetic_corpus(),
                     bert_tokenizer=get_bert_tokenizer() if bert else None, **kw)
    assert jds.augment and pds.augment
    for epoch in (0, 3):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        assert len(jds) == len(pds) > 4
        for i in range(len(pds)):
            _item_close(pds[i], jds[i], ("images", "word_ids", "word_mask", "bbox"))
    a = JaxVID(index, jax_corpus(), legacy_hsv=True, **kw)
    b = VIDDataset(index, build_synthetic_corpus(), legacy_hsv=True, **kw)
    _item_close(b[1], a[1], ("images", "bbox"))


def test_augmented_referit_items_match_jax(train_split):
    index = os.path.join(train_split, "referit_train.json")
    kw = dict(dataset="referit", imsize=64, max_query_len=20, augment=True,
              image_root=train_split, seed=3)
    jds = JaxReferIt(index, jax_corpus(), use_native=False, **kw)
    pds = ReferItDataset(index, build_synthetic_corpus(), **kw)
    for epoch in (0, 2):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        for i in range(len(pds)):
            _item_close(pds[i], jds[i], ("images", "word_ids", "bbox"))


def test_losses_extra_match_jax():
    rng = np.random.RandomState(0)
    size, b = 64, 6
    cfg, jcfg = DCNetConfig(image_size=size), JaxConfig(image_size=size)
    outbox = [rng.randn(b, 3, 5, g, g).astype(np.float32) for g in cfg.grids]
    x1, y1 = rng.rand(b) * 30, rng.rand(b) * 30
    box = np.stack([x1, y1, x1 + 5 + rng.rand(b) * 25, y1 + 5 + rng.rand(b) * 25],
                   1).astype(np.float32)
    tout = [torch.from_numpy(o) for o in outbox]
    jout = [jnp.asarray(o) for o in outbox]
    tgt, jtgt = build_target(torch.from_numpy(box), cfg), jax_build_target(jnp.asarray(box), jcfg)
    logits = rng.randn(b, 7).astype(np.float32)
    labels = rng.randint(0, 7, b)
    pairs = [
        (pextra.offset_loss(tout, tgt, cfg), jextra.offset_loss(jout, jtgt, jcfg)),
        (pextra.confidence_loss(tout), jextra.confidence_loss(jout)),
        (pextra.iou_loss(torch.from_numpy(box), torch.from_numpy(box[::-1].copy())),
         jextra.iou_loss(jnp.asarray(box), jnp.asarray(box[::-1].copy()))),
        (pextra.weighted_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels)),
         jextra.weighted_ce_loss(jnp.asarray(logits), jnp.asarray(labels))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)


class _Indexed:
    """Items that name their index (and an odd-sized array)."""

    def __len__(self):
        return 23

    def __getitem__(self, i):
        return {"i": np.asarray([i]), "x": np.full((2, 3), i, np.float32),
                "name": f"item{i}"}


@pytest.mark.parametrize("shards,num_workers", [((1, 0), 0), ((3, 1), 0), ((3, 1), 2)])
def test_grain_loader_order_matches_batch_iterator(shards, num_workers):
    """Worker processes are spawned (~7 s here), so one case takes them."""
    n, idx = shards
    for shuffle in (False, True) if num_workers == 0 else (True,):
        want = list(jax_batch_iterator(_Indexed(), 4, shuffle=shuffle, seed=11,
                                       num_shards=n, shard_index=idx))
        got = list(grain_loader(_Indexed(), 4, shuffle=shuffle, seed=11,
                                num_workers=num_workers, num_shards=n,
                                shard_index=idx))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["i"], w["i"])
            np.testing.assert_array_equal(g["x"], w["x"])
            assert g["name"] == w["name"]
    two = list(grain_loader(_Indexed(), 23, shuffle=True, seed=11, num_epochs=2,
                            drop_remainder=False))
    assert [sorted(b["i"][:, 0].tolist()) for b in two] == [list(range(23))] * 2
    assert two[0]["i"].tolist() != two[1]["i"].tolist()
