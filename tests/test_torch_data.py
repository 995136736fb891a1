"""The port's data path against the JAX package's (cv2) one.

- `resize` and `letterbox` give cv2's uint8 pixels exactly: on every frame
  of the `data/synthetic32` test split (regenerated from seed 13 into a
  temporary directory) and on random sizes, shrinking and growing, at 64
  and 256 px.
- `generate_synthetic_vid` writes the JAX package's index, its `.jpg` bytes
  and, as `.npy`, the pixels the JAX package renders.
- `VIDDataset` and `ReferItDataset` test items equal the JAX package's.
- The tensor resizes, corpus, metrics and reference cache match their JAX
  counterparts.
"""

import json
import os
import sys
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from dcnet_tpu.data import corpus as jcorpus
from dcnet_tpu.data import synthetic as jsynthetic
from dcnet_tpu.data import transforms as JT
from dcnet_tpu.data.referit import ReferItDataset as JaxReferIt
from dcnet_tpu.data.vid import VIDDataset as JaxVID
from dcnet_tpu.data.vid import batch_iterator as jax_batch_iterator
from dcnet_tpu.eval import metrics as jmetrics
from dcnet_tpu.eval import ref_cache as jref_cache
from dcnet_tpu.eval.temporal import FrameCache as JaxFrameCache
from dcnet_tpu_torch.data import corpus as pcorpus
from dcnet_tpu_torch.data import synthetic as psynthetic
from dcnet_tpu_torch.data import transforms as T
from dcnet_tpu_torch.data.referit import ReferItDataset
from dcnet_tpu_torch.data.vid import (
    VIDDataset, batch_iterator, load_index, prefetch_to_device, read_image)
from dcnet_tpu_torch.eval import metrics as pmetrics
from dcnet_tpu_torch.eval import ref_cache as pref_cache
from dcnet_tpu_torch.eval.temporal import FrameCache

ROWS = 10


@pytest.fixture(scope="module")
def synthetic32(tmp_path_factory):
    """The data/synthetic32 test split (seed 13, 32 videos x 8 frames of
    320x480), written by the JAX package."""
    root = str(tmp_path_factory.mktemp("synthetic32"))
    jsynthetic.generate_synthetic_vid(root, "test", num_videos=32,
                                      frames_per_video=8, seed=13)
    return root


def _frames(root):
    return sorted(os.path.join(root, "frames", n)
                  for n in os.listdir(os.path.join(root, "frames")))


@pytest.mark.parametrize("size", [64, 256])
def test_letterbox_equals_cv2_on_synthetic32(synthetic32, size):
    paths = _frames(synthetic32)
    assert len(paths) == 256
    for p in paths:
        img = read_image(p)
        got, ratio, dw, dh = T.letterbox(img, size)
        want, wr, wdw, wdh = JT.letterbox(img, size)
        assert (ratio, dw, dh) == (wr, wdw, wdh)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), p


@pytest.mark.parametrize("size", [64, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_letterbox_equals_cv2_on_random_sizes(size, seed):
    rng = np.random.default_rng(seed)
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(24, 900, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = T.letterbox(img, size)
        want = JT.letterbox(img, size)
        assert got[1:] == want[1:]
        assert np.array_equal(got[0], want[0]), (h, w, size)


@pytest.mark.parametrize("interp", ["area", "linear"])
@pytest.mark.parametrize("shape", ["hwc", "hw", "integer"])
def test_resize_equals_cv2(interp, shape):
    """Shrinking and growing, odd sizes, gray images and integer scales
    (cv2's fast 2x2 box rounds half up)."""
    flag = {"area": cv2.INTER_AREA, "linear": cv2.INTER_LINEAR}[interp]
    rng = np.random.default_rng(7)
    for _ in range(10):
        if shape == "integer":
            h, w = (int(v) for v in rng.integers(3, 90, 2))
            k = int(rng.integers(2, 5))
            src = (k * h, k * w, 3)
        else:
            src = tuple(int(v) for v in rng.integers(5, 500, 2))
            h, w = (int(v) for v in rng.integers(3, 300, 2))
            if shape == "hwc":
                src += (3,)
        img = rng.integers(0, 256, src, dtype=np.uint8)
        got = T.resize(img, (w, h), interp)
        want = cv2.resize(img, (w, h), interpolation=flag)
        assert got.shape == want.shape and np.array_equal(got, want), (src, h, w)


def test_resize_refuses_float_images():
    with pytest.raises(TypeError, match="uint8"):
        T.resize(np.zeros((8, 8, 3), np.float32), (4, 4))


def test_resize_pad_equals_jax():
    rng = np.random.default_rng(3)
    for src, size in (((40, 60, 3), (64, 64)), ((300, 200), (128, 96)),
                      ((17, 90, 3), (32, 48))):
        img = rng.integers(0, 256, src, dtype=np.uint8)
        assert np.array_equal(T.resize_pad(img, size), JT.resize_pad(img, size))


@pytest.mark.parametrize("fn,args", [
    ("crop_resize", ((40, 60),)), ("crop_resize", ((13, 9),)),
    ("resize_image", (48,)), ("resize_image", (11,)),
    ("resize_annotation", (50,)), ("resize_annotation", (7,))])
def test_tensor_resizes_match_jax(fn, args):
    """F.interpolate (antialiased when shrinking) against jax.image.resize."""
    x = np.random.default_rng(1).random((3, 20, 30)).astype(np.float32)
    x = x[0] if fn != "resize_image" else x
    got = getattr(T, fn)(x, *args).numpy()
    want = np.asarray(getattr(JT, fn)(x, *args))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_normalize_and_box_geometry_match_jax():
    img = np.random.default_rng(2).integers(0, 256, (9, 7, 3), dtype=np.uint8)
    assert np.array_equal(T.normalize_image(img), JT.normalize_image(img))
    norm = JT.normalize_image(img)
    assert np.array_equal(T.denormalize_image(norm), JT.denormalize_image(norm))
    box = np.array([10.5, 3.0, 40.0, 22.25])
    assert np.array_equal(T.inverse_letterbox_box(box, 0.4, 1.5, 3.0),
                          JT.inverse_letterbox_box(box, 0.4, 1.5, 3.0))


def test_synthetic_jpg_equals_jax(tmp_path):
    """Same index and byte-identical .jpg files from the same seed."""
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    for split in ("train", "test"):
        ji = jsynthetic.generate_synthetic_vid(jroot, split, num_videos=3,
                                               frames_per_video=4, seed=5)
        pi = psynthetic.generate_synthetic_vid(proot, split, num_videos=3,
                                               frames_per_video=4, seed=5)
        with open(ji) as a, open(pi) as b:
            assert json.load(a) == json.load(b)
    for p in _frames(jroot):
        with open(p, "rb") as a, open(p.replace(jroot, proot), "rb") as b:
            assert a.read() == b.read()


def test_synthetic_npy_holds_jax_rendered_pixels(tmp_path, monkeypatch):
    rendered = []
    monkeypatch.setattr(cv2, "imwrite",
                        lambda path, bgr: rendered.append(bgr[..., ::-1].copy()) or True)
    ji = jsynthetic.generate_synthetic_vid(str(tmp_path / "jax"), "test",
                                           num_videos=2, frames_per_video=5, seed=9)
    monkeypatch.undo()
    root = str(tmp_path / "port")
    pi = psynthetic.generate_synthetic_vid(root, "test", num_videos=2,
                                           frames_per_video=5, seed=9,
                                           frame_format="npy")
    with open(ji) as a, open(pi) as b:
        jidx, pidx = json.load(a), json.load(b)
    flat = [f for v in pidx for f in v]
    assert [f[1:] for v in jidx for f in v] == [f[1:] for f in flat]
    assert [f[0].replace(".jpg", ".npy") for v in jidx for f in v] == [f[0] for f in flat]
    for (rel, _, _), want in zip(flat, rendered):
        assert np.array_equal(read_image(os.path.join(root, rel)), want)


def test_vid_items_equal_jax(synthetic32):
    index = os.path.join(synthetic32, "VID_video_level_test.json")
    kw = dict(split="test", imsize=64, num_frame_k=5, max_query_len=20,
              testmode=True, image_root=synthetic32, seed=13)
    jds = JaxVID(index, jsynthetic.build_synthetic_corpus(), **kw)
    pds = VIDDataset(index, psynthetic.build_synthetic_corpus(), **kw)
    assert len(pds) == len(jds) > ROWS
    for i in range(ROWS):
        want, got = jds[i], pds[i]
        assert set(got) == set(want)
        for key in ("images", "bbox", "ratio", "dw", "dh", "word_ids",
                    "word_mask", "video_id"):
            assert got[key].dtype == want[key].dtype, key
            assert np.array_equal(got[key], want[key]), (i, key)
        assert got["paths"] == want["paths"] and got["phrases"] == want["phrases"]


def test_batch_iterator_and_prefetch(synthetic32):
    index = os.path.join(synthetic32, "VID_video_level_test.json")
    kw = dict(split="test", imsize=64, num_frame_k=3, testmode=True,
              image_root=synthetic32)
    jds = JaxVID(index, jsynthetic.build_synthetic_corpus(), **kw)
    pds = VIDDataset(index, psynthetic.build_synthetic_corpus(), **kw)
    pds.chunks, jds.chunks = pds.chunks[:11], jds.chunks[:11]
    it = dict(batch_size=3, drop_last=False, num_shards=2, shard_index=1)
    jb = list(jax_batch_iterator(jds, num_workers=0, **it))
    pb = list(batch_iterator(pds, num_workers=2, **it))
    assert len(pb) == len(jb) == 2
    for g, w in zip(pb, jb):
        assert np.array_equal(g["images"], w["images"]) and g["paths"] == w["paths"]
    serial = list(batch_iterator(pds, num_workers=0, **it))
    for g, w in zip(serial, jb):
        assert np.array_equal(g["images"], w["images"]) and g["paths"] == w["paths"]
    moved = list(prefetch_to_device(iter(pb), "cpu"))
    assert torch.equal(moved[0]["images"], torch.from_numpy(pb[0]["images"]))
    assert moved[1]["paths"] == pb[1]["paths"]

    def broken():
        yield pb[0]
        raise OSError("disk gone")
    with pytest.raises(OSError, match="disk gone"):
        list(prefetch_to_device(broken(), "cpu"))


@pytest.mark.parametrize("dataset", ["referit", "unc"])
def test_referit_items_equal_jax(synthetic32, tmp_path, dataset):
    frames = _frames(synthetic32)[:3]
    boxes = [[10.0, 12.0, 90.0, 70.0], [0.0, 5.0, 33.0, 41.0], [100, 50, 60, 80]]
    if dataset == "unc":  # (img, mask, xywh box, phrase, attributes)
        entries = [[f, None, b, "The red box.", []] for f, b in zip(frames, boxes)]
    else:
        entries = [[f, b, "the LEFT green box"] for f, b in zip(frames, boxes)]
    index = str(tmp_path / "index.json")
    with open(index, "w") as f:
        json.dump(entries, f)
    kw = dict(dataset=dataset, imsize=64, testmode=True)
    jds = JaxReferIt(index, jsynthetic.build_synthetic_corpus(), **kw)
    pds = ReferItDataset(index, psynthetic.build_synthetic_corpus(), **kw)
    for i in range(len(entries)):
        want, got = jds[i], pds[i]
        assert set(got) == set(want)
        for key in ("images", "bbox", "ratio", "dw", "dh", "word_ids", "word_mask"):
            assert np.array_equal(got[key], want[key]), (i, key)
        assert got["paths"] == want["paths"] and got["phrases"] == want["phrases"]


def test_read_image_names_the_missing_decoder(tmp_path, monkeypatch):
    img = np.random.default_rng(0).integers(0, 256, (5, 6, 3), dtype=np.uint8)
    np.save(tmp_path / "f.npy", img)
    np.save(tmp_path / "g.npy", img[..., 0])
    assert np.array_equal(read_image(str(tmp_path / "f.npy")), img)
    assert read_image(str(tmp_path / "g.npy")).shape == (5, 6, 3)
    with pytest.raises(FileNotFoundError):
        read_image(str(tmp_path / "missing.jpg"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        read_image(str(tmp_path / "f.jpg"))
    with pytest.raises(RuntimeError, match="cv2"):
        psynthetic.generate_synthetic_vid(str(tmp_path / "s"), "test",
                                          num_videos=1, frames_per_video=2)


@pytest.mark.parametrize("kwargs,item", [
    (dict(augment=True), "11"), (dict(use_native=True), "13"),
    (dict(bert_tokenizer=object()), "10")])
def test_unported_dataset_options_raise(synthetic32, tmp_path, kwargs, item):
    """Every option of the datasets is ported now: the C++ host loader
    (item 13; held against the JAX core in tests/test_torch_native.py), the
    augmentations (item 11) and the BERT tokenizer (item 10; held against
    the JAX package in tests/test_torch_augment.py): the datasets build and
    give an item, and the host loader's item equals the numpy path's."""
    index = os.path.join(synthetic32, "VID_video_level_test.json")
    corpus = psynthetic.build_synthetic_corpus()
    if item == "13":
        kw = dict(split="test", image_root=synthetic32, imsize=64, testmode=True)
        got = VIDDataset(index, corpus, **kwargs, **kw)[0]
        want = VIDDataset(index, corpus, use_native=False, **kw)[0]
        for key in ("images", "bbox", "ratio", "dw", "dh", "word_ids"):
            assert np.array_equal(got[key], want[key]), key
        entries = str(tmp_path / "referit.json")
        with open(entries, "w") as f:
            json.dump([[row[0], row[1], row[2]] for row in load_index(index)[0][:2]], f)
        kw = dict(image_root=synthetic32, imsize=64)
        got = ReferItDataset(entries, corpus, **kwargs, **kw)[1]
        want = ReferItDataset(entries, corpus, use_native=False, **kw)[1]
        assert all(np.array_equal(got[k], want[k]) for k in ("images", "bbox"))
        return
    if item == "10":
        from dcnet_tpu_torch.data.bert_tokenize import get_bert_tokenizer
        kwargs, corpus = dict(bert_tokenizer=get_bert_tokenizer()), None
    ds = VIDDataset(index, corpus, split="test", image_root=synthetic32,
                    imsize=64, **kwargs)
    item0 = ds[0]
    assert item0["images"].shape == (2, 64, 64, 3) and item0["word_ids"].any()
    ReferItDataset(index, corpus, **kwargs).set_epoch(1)


def test_corpus_matches_jax(tmp_path):
    phrases = jsynthetic.synthetic_phrases() + ["A man, riding a horse."]
    jc, pc = jcorpus.Corpus.build(phrases), pcorpus.Corpus.build(phrases)
    assert pc.idx2word == jc.idx2word
    for line in ("The small red box moving left.", "an unseen word, here",
                 "x " * 30):
        assert np.array_equal(pc.tokenize(line, 20), jc.tokenize(line, 20))
    pc.save(str(tmp_path / "c.json"))
    assert jcorpus.Corpus.load(str(tmp_path / "c.json")).idx2word == pc.idx2word
    ref = SimpleNamespace(dictionary=SimpleNamespace(idx2word=["a", "b", "<unk>"]))
    torch.save(ref, str(tmp_path / "corpus.pth"))
    assert (pcorpus.load_reference_corpus(str(tmp_path / "corpus.pth")).idx2word
            == jcorpus.load_reference_corpus(str(tmp_path / "corpus.pth")).idx2word)


def test_extra_metrics_match_jax():
    rng = np.random.default_rng(4)
    pred, gt = rng.random(50), rng.random(50)
    assert pmetrics.multiclass_metrics(pred, gt) == jmetrics.multiclass_metrics(pred, gt)
    assert (pmetrics.multiclass_metrics(np.zeros(4), np.zeros(4))
            == jmetrics.multiclass_metrics(np.zeros(4), np.zeros(4)))
    trues = [rng.integers(-1, 4, (6, 7)) for _ in range(3)]
    preds = [rng.integers(0, 4, (6, 7)) for _ in range(3)]
    assert (pmetrics.segmentation_metrics(trues, preds, 4)
            == jmetrics.segmentation_metrics(trues, preds, 4))
    rec, prec = np.sort(rng.random(9)), rng.random(9)
    assert pmetrics.compute_ap(rec, prec) == jmetrics.compute_ap(rec, prec)


def test_reference_cache_round_trips_with_jax(tmp_path):
    rng = np.random.default_rng(6)
    boxes = rng.random((3, 5, 4)).astype(np.float32) * 100
    scores = rng.random((3, 5)).astype(np.float32)
    feats = rng.random((3, 5, 8)).astype(np.float32)
    paths = [f"VID/vid_{i // 2}/{i:06d}.JPEG" for i in range(3)]
    pref_cache.write_reference_cache(str(tmp_path / "p"), paths, FrameCache(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(feats)))
    back = jref_cache.read_reference_cache(str(tmp_path / "p"), paths)
    jref_cache.write_reference_cache(str(tmp_path / "j"), paths,
                                     JaxFrameCache(boxes, scores, feats))
    mine = pref_cache.read_reference_cache(str(tmp_path / "j"), paths)
    for want, a, b in zip((boxes, scores, feats), back, mine):
        assert np.array_equal(np.asarray(a), want)
        assert np.array_equal(b.numpy(), want)
