"""The port's C++ host loader (`dcnet_tpu_torch/native`) against the JAX
package's core (`dcnet_tpu.native`, built here too) and against the port's
own numpy path (`read_image` -> `letterbox` -> `normalize_image`).

- PNG frames: images and geometry equal the JAX core's bitwise (the shapes
  of tests/test_native.py); JPEG and gray JPEG bitwise where both cores
  link the same libjpeg, else within tests/test_native.py's 2/255.
- `.npy` frames, which the JAX core cannot read: bitwise the numpy path at
  every size, shrinking and growing, gray, (H, W, 1) and Fortran order.
- Failed decodes flagged; `decode_batch_rgb` equal to the JAX core and to
  `read_image`; the threads change nothing.
- The datasets give equal items with and without the core, untransformed
  (the fused call) and augmented (the decode call); the explicit-request
  rules: `use_native=True` raises where the core is unavailable, disabled
  by DCNET_NO_NATIVE, cannot read a format (naming its header) or did not
  build (with the compiler's output); None falls back quietly.
"""

import os
import re
import subprocess

import cv2
import numpy as np
import pytest

from dcnet_tpu import native as jnative
from dcnet_tpu_torch import native
from dcnet_tpu_torch.data import transforms as T
from dcnet_tpu_torch.data.referit import ReferItDataset
from dcnet_tpu_torch.data.synthetic import build_synthetic_corpus, generate_synthetic_vid
from dcnet_tpu_torch.data.vid import VIDDataset, letterbox_frames, read_image

PNG_SHAPES = [(480, 640), (333, 217), (64, 64), (721, 405), (13, 999)]
JPEG_TOL = 2.0 / 255.0 / float(T.IMAGENET_STD.min())   # tests/test_native.py's


@pytest.fixture(scope="module", autouse=True)
def core():
    """The core builds here (g++, libjpeg's and OpenCV's headers)."""
    assert native.available(), native.unavailable_reason()
    assert native.formats() == ("npy", "jpeg", "opencv")


def _images(tmp_path, shapes, ext, seed=0):
    rng = np.random.RandomState(seed)
    paths = []
    for i, (h, w) in enumerate(shapes):
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        p = str(tmp_path / f"img{i}.{ext}")
        if ext == "npy":
            np.save(p, img)
        else:
            cv2.imwrite(p, img)
        paths.append(p)
    return paths


def _numpy_path(path, size):
    boxed, ratio, dw, dh = T.letterbox(read_image(path), size)
    return T.normalize_image(boxed), ratio, dw, dh


def _libjpeg(lib) -> str:
    """The libjpeg a loaded core links, by ldd ('' where ldd is missing)."""
    try:
        out = subprocess.run(["ldd", lib], capture_output=True, text=True, timeout=30).stdout
    except OSError:
        return ""
    return " ".join(re.findall(r"(\S*libjpeg\S*) => (\S+)", out)[0]) if "libjpeg" in out else ""


@pytest.mark.parametrize("size", [256, 128])
def test_png_frames_equal_the_jax_core_bitwise(tmp_path, size):
    paths = _images(tmp_path, PNG_SHAPES, "png")
    got = native.decode_letterbox_batch(paths, size, T.IMAGENET_MEAN, T.IMAGENET_STD)
    want = jnative.decode_letterbox_batch(paths, size, T.IMAGENET_MEAN, T.IMAGENET_STD)
    assert got[4].all() and want[4].all()
    for name, g, w in zip(("images", "ratios", "dws", "dhs"), got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), name


def test_jpeg_frames_against_the_jax_core(tmp_path):
    """Colour and gray JPEGs: bitwise where both cores link one libjpeg."""
    paths = _images(tmp_path, [(300, 400), (77, 191)], "jpg")
    gray = np.random.RandomState(7).randint(0, 256, (240, 320), np.uint8)
    cv2.imwrite(str(tmp_path / "g.jpg"), gray)
    paths.append(str(tmp_path / "g.jpg"))
    got = native.decode_letterbox_batch(paths, 128, T.IMAGENET_MEAN, T.IMAGENET_STD)
    want = jnative.decode_letterbox_batch(paths, 128, T.IMAGENET_MEAN, T.IMAGENET_STD)
    same = _libjpeg(native._get().lib._name) == _libjpeg(jnative._SO) != ""
    for g, w in zip(got[:4], want[:4]):
        if same:
            assert np.array_equal(g, w)
        else:
            assert np.abs(g - w).max() <= JPEG_TOL
    for p, img in zip(paths, got[0]):   # and the port's cv2 path
        assert np.abs(img - _numpy_path(p, 128)[0]).max() <= JPEG_TOL


def test_failed_decodes_are_flagged(tmp_path):
    paths = _images(tmp_path, [(100, 100)], "npy")
    (tmp_path / "bad.npy").write_bytes(b"\x93NUMPY not an array")
    np.save(tmp_path / "f32.npy", np.zeros((4, 4, 3), np.float32))
    paths += [str(tmp_path / "missing.png"), str(tmp_path / "bad.npy"),
              str(tmp_path / "f32.npy")]
    out, ratios, dws, dhs, ok = native.decode_letterbox_batch(
        paths, 64, T.IMAGENET_MEAN, T.IMAGENET_STD)
    assert list(ok) == [True, False, False, False]
    assert (out[1:] == 0).all() and list(ratios[1:]) == [1.0] * 3 and not dws[1:].any()
    assert native.decode_batch_rgb(paths)[1:] == [None, None, None]
    assert isinstance(native.decode_failed(paths[1]), FileNotFoundError)
    assert isinstance(native.decode_failed(paths[2]), ValueError)


def test_decode_batch_rgb_equals_the_jax_core_and_read_image(tmp_path):
    paths = _images(tmp_path, [(240, 320), (77, 191)], "png")
    paths += _images(tmp_path, [(50, 60)], "jpg", seed=3)
    got = native.decode_batch_rgb(paths)
    for g, w, p in zip(got, jnative.decode_batch_rgb(paths), paths):
        assert g.dtype == np.uint8 and np.array_equal(g, w)
        assert np.array_equal(g, read_image(p))


@pytest.mark.parametrize("size", [256, 64])
def test_npy_frames_equal_the_numpy_path_bitwise(tmp_path, size):
    """Shrinking (area tables, the 2 x 2 and 5 x 5 integer paths) and
    growing axes, gray (H, W) and (H, W, 1) arrays, Fortran order."""
    shapes = [(320, 480), (720, 1280), (13, 999), (64, 64), (255, 10), (512, 512),
              (100, 37), (1, 1)]
    paths = _images(tmp_path, shapes, "npy")
    rng = np.random.RandomState(5)
    for name, arr in (("gray", rng.randint(0, 256, (240, 320), np.uint8)),
                      ("gray1", rng.randint(0, 256, (31, 17, 1), np.uint8)),
                      ("fortran", np.asfortranarray(rng.randint(0, 256, (50, 70, 3), np.uint8)))):
        np.save(tmp_path / f"{name}.npy", arr)
        paths.append(str(tmp_path / f"{name}.npy"))
    out, ratios, dws, dhs, ok = native.decode_letterbox_batch(
        paths, size, T.IMAGENET_MEAN, T.IMAGENET_STD)
    assert ok.all()
    for i, p in enumerate(paths):
        img, ratio, dw, dh = _numpy_path(p, size)
        assert np.array_equal(out[i], img), p
        assert (ratios[i], dws[i], dhs[i]) == (ratio, dw, dh), p
    for p, img in zip(paths, native.decode_batch_rgb(paths)):
        assert np.array_equal(img, read_image(p))


def test_threads_change_nothing(tmp_path):
    paths = _images(tmp_path, [(320, 480)] * 6 + [(90, 70)] * 3, "npy", seed=2)
    one = native.decode_letterbox_batch(paths, 96, T.IMAGENET_MEAN, T.IMAGENET_STD,
                                        num_threads=1)
    many = native.decode_letterbox_batch(paths, 96, T.IMAGENET_MEAN, T.IMAGENET_STD,
                                         num_threads=9)
    assert all(np.array_equal(a, b) for a, b in zip(one, many))


def _split(tmp_path, split, frame_format):
    root = str(tmp_path / f"{split}_{frame_format}")
    index = generate_synthetic_vid(root, split, num_videos=2, frames_per_video=5,
                                   frame_format=frame_format)
    return root, index


def _equal_items(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("frame_format", ["npy", "jpg"])
@pytest.mark.parametrize("split,augment", [("test", False), ("train", True)])
def test_vid_dataset_with_the_core_equals_without(tmp_path, split, augment, frame_format):
    root, index = _split(tmp_path, split, frame_format)
    kw = dict(split=split, imsize=64, num_frame_k=2, image_root=root,
              testmode=split == "test", augment=augment)
    ds_np = VIDDataset(index, build_synthetic_corpus(), use_native=False, **kw)
    ds_cc = VIDDataset(index, build_synthetic_corpus(), use_native=True, **kw)
    native.reset_calls()
    for idx in range(min(3, len(ds_np))):
        _equal_items(ds_cc[idx], ds_np[idx])
    key = "decode_batch_rgb" if augment else "decode_letterbox_batch"
    assert native.CALLS[key] == min(3, len(ds_np))


@pytest.mark.parametrize("augment", [False, True])
def test_referit_dataset_with_the_core_equals_without(tmp_path, augment):
    import json
    root, index = _split(tmp_path, "test", "npy")
    entries = str(tmp_path / "referit.json")
    with open(entries, "w") as f:
        with open(index) as g:
            json.dump([list(row) for video in json.load(g) for row in video][:4], f)
    kw = dict(imsize=64, image_root=root, testmode=not augment, augment=augment)
    a = ReferItDataset(entries, build_synthetic_corpus(), use_native=True, **kw)
    b = ReferItDataset(entries, build_synthetic_corpus(), use_native=False, **kw)
    for idx in range(len(a)):
        _equal_items(a[idx], b[idx])


def test_stream_eval_frames_with_the_core_equal_without(tmp_path):
    root, index = _split(tmp_path, "test", "npy")
    frames = sorted(os.path.join(root, "frames", n) for n in os.listdir(os.path.join(root, "frames")))
    got = letterbox_frames(frames, 64, True)
    want = letterbox_frames(frames, 64, False)
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]


def test_an_explicit_request_raises_where_the_core_is_unavailable(tmp_path, monkeypatch):
    root, index = _split(tmp_path, "test", "npy")
    kw = dict(split="test", imsize=64, num_frame_k=2, image_root=root)
    want = VIDDataset(index, build_synthetic_corpus(), use_native=False, **kw)[0]
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="requested .use_native=True. and cannot read"):
        VIDDataset(index, build_synthetic_corpus(), use_native=True, **kw)[0]
    native.reset_calls()
    _equal_items(VIDDataset(index, build_synthetic_corpus(), **kw)[0], want)
    assert native.CALLS["decode_letterbox_batch"] == 0
    monkeypatch.undo()
    monkeypatch.setenv("DCNET_NO_NATIVE", "1")
    assert not native.available() and "DCNET_NO_NATIVE" in native.unavailable_reason()
    assert native.formats() == ()
    with pytest.raises(RuntimeError, match="DCNET_NO_NATIVE"):
        VIDDataset(index, build_synthetic_corpus(), use_native=True, **kw)[0]
    _equal_items(VIDDataset(index, build_synthetic_corpus(), **kw)[0], want)
    assert native.CALLS["decode_letterbox_batch"] == 0


def test_an_explicit_request_names_the_missing_header(tmp_path, monkeypatch):
    """A build without libjpeg and OpenCV reads .npy only: a JPEG split
    raises under use_native=True, naming jpeglib.h, and takes the cv2 path
    under None; a .npy split still takes the core."""
    built = native._get()
    monkeypatch.setattr(native, "_core", native._Core(
        built.lib, ("npy",), {"jpeg": "jpeglib.h was not found under /usr/include",
                              "opencv": "opencv4/opencv2/imgcodecs.hpp was not found"},
        None))
    root, index = _split(tmp_path, "test", "jpg")
    kw = dict(split="test", imsize=64, num_frame_k=2, image_root=root)
    with pytest.raises(RuntimeError, match="reads no jpeg files: jpeglib.h"):
        VIDDataset(index, build_synthetic_corpus(), use_native=True, **kw)[0]
    png = str(tmp_path / "x.png")
    assert "opencv4" in native.missing(png) and not native.reads([png])
    native.reset_calls()
    _equal_items(VIDDataset(index, build_synthetic_corpus(), **kw)[0],
                 VIDDataset(index, build_synthetic_corpus(), use_native=False, **kw)[0])
    assert native.CALLS["decode_letterbox_batch"] == 0
    root, index = _split(tmp_path, "test", "npy")
    VIDDataset(index, build_synthetic_corpus(), split="test", imsize=64, num_frame_k=2,
               image_root=root, use_native=True)[0]
    assert native.CALLS["decode_letterbox_batch"] == 1


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """No library cached under the build directory and a compiler that
    fails: the core is unavailable, an explicit request says why."""
    monkeypatch.setattr(native, "_core", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    script = tmp_path / "cxx"
    script.write_text("#!/bin/sh\necho 'error: no such toolchain' >&2\nexit 1\n")
    script.chmod(0o755)
    monkeypatch.setenv("CXX", str(script))
    assert not native.available()
    assert "did not build" in native.unavailable_reason()
    assert "error: no such toolchain" in native.unavailable_reason()
    with pytest.raises(RuntimeError, match="no such toolchain"):
        native.use_core(True, [str(tmp_path / "f.npy")])
    assert not native.use_core(None, [str(tmp_path / "f.npy")])


def test_the_library_is_named_by_its_source_and_flags(monkeypatch):
    a = native._target(["-O3"])
    assert os.path.dirname(a) == native.BUILD_DIR and a != native._target(["-O2"])
    assert os.path.basename(a).startswith("host_loader-") and a.endswith(".so")
    assert "-ffp-contract=off" in native.CXX_FLAGS
