"""Host-side image transforms of the eval pipeline: the port of
`dcnet_tpu/data/transforms.py` without cv2.

The JAX package letterboxes with `cv2.resize(..., INTER_AREA)` and
`cv2.copyMakeBorder`. This module computes the same uint8 pixels in numpy:
`resize` reproduces cv2's arithmetic for 8-bit images, and the tests hold it
against cv2 pixel for pixel.

- INTER_AREA, shrinking on both axes (the letterbox of any frame larger than
  the target): cv2's area-weight tables (`computeResizeAreaTab`) applied
  along x and then along y in float32, in cv2's order of summation, then
  rounded half to even and saturated. At an integer scale cv2 takes its
  fast path instead: a 2 x 2 box sum rounded half up, `(sum + 2) >> 2`, and
  other integer boxes `rint(float(sum) * (1/area))`.
- INTER_LINEAR, and INTER_AREA when an axis grows: cv2's fixed-point
  bilinear. 11-bit weights from the float32 source offsets (INTER_AREA
  computes those offsets from the pixel edges), integer sums along x, and
  the vertical blend as cv2's vector code rounds it:
  `(((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2) >> 2`.

Only uint8 images are resized (every frame the datasets decode is uint8);
other dtypes raise. The tensor resizes (`crop_resize`, `resize_image`,
`resize_annotation`) use `F.interpolate` where the JAX package uses
`jax.image.resize` (bilinear, antialiased when shrinking).

The training augmentations draw from the numpy Generator in the JAX
package's order and compute cv2's 8-bit arithmetic (that of cv2 5.0 on
x86-64): `horizontal_flip` with the left/right phrase swap; `hsv_jitter`
through `rgb_to_hsv` (cv2's integer tables, hsv_shift 12) and `hsv_to_rgb`
(cv2's float32 path with its FMAs, truncated in its vector blocks of 32
pixels a row and rounded in the scalar tail); `random_affine` through
`rotation_matrix` (getRotationMatrix2D), `warp_perspective` (cv2's float32
warp kernel: the inverted matrix in float32, FMA coordinates, an FMA
bilinear blend, the border colour outside) and `wrap_points`. Flip and
HSV equal cv2 pixel for pixel; the warp is within one level in at most
1e-4 of the values (`tests/test_torch_augment.py`), the FMAs being
emulated in float64.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ImageNet normalization
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
PAD_COLOR = (123.7, 116.3, 103.5)

_COEF_BITS = 11                 # cv2's INTER_RESIZE_COEF_BITS
_COEF_ONE = 1 << _COEF_BITS


def _area_table(ssize: int, dsize: int, scale: float):
    """(destination index, source index, float32 weight) per term, grouped
    by destination in cv2's order (`computeResizeAreaTab`)."""
    di, si, al = [], [], []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            di.append(d); si.append(s1 - 1); al.append((s1 - f1) / cell)
        for s in range(s1, s2):
            di.append(d); si.append(s); al.append(1.0 / cell)
        if f2 - s2 > 1e-3:
            di.append(d); si.append(s2); al.append(min(min(f2 - s2, 1.0), cell) / cell)
    return np.asarray(di), np.asarray(si), np.asarray(al, np.float32)


def _terms(dst: np.ndarray):
    """For a table sorted by destination: per round j, the table rows that
    hold the j-th term of their destination."""
    starts = np.r_[0, np.nonzero(np.diff(dst))[0] + 1]
    ends = np.r_[starts[1:], len(dst)]
    for j in range(int((ends - starts).max())):
        yield (starts + j)[starts + j < ends]


def _resize_area(img: np.ndarray, w: int, h: int, sx: float, sy: float) -> np.ndarray:
    """cv2's INTER_AREA for sx, sy >= 1 (non-integer): img (H, W, C) uint8."""
    xd, xs, xa = _area_table(img.shape[1], w, sx)
    yd, ys, ya = _area_table(img.shape[0], h, sy)
    src = img.astype(np.float32)
    buf = np.zeros((img.shape[0], w, img.shape[2]), np.float32)
    for k in _terms(xd):          # buf[:, d] += src[:, s] * alpha, in order
        buf[:, xd[k]] = buf[:, xd[k]] + src[:, xs[k]] * xa[k][None, :, None]
    out = np.zeros((h, w, img.shape[2]), np.float32)
    for j, k in enumerate(_terms(yd)):
        term = ya[k][:, None, None] * buf[ys[k]]
        out[yd[k]] = term if j == 0 else out[yd[k]] + term
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _resize_area_integer(img: np.ndarray, w: int, h: int, kx: int, ky: int) -> np.ndarray:
    """cv2's INTER_AREA fast path at integer scales kx, ky."""
    c = img.shape[2]
    sums = img[:h * ky, :w * kx].astype(np.int64).reshape(h, ky, w, kx, c).sum((1, 3))
    if kx == 2 and ky == 2:
        return ((sums + 2) >> 2).astype(np.uint8)
    scaled = sums.astype(np.float32) * np.float32(1.0 / (kx * ky))
    return np.clip(np.rint(scaled), 0, 255).astype(np.uint8)


def _linear_table(ssize: int, dsize: int, scale: float, inv_scale: float,
                  area: bool, clamp: bool):
    """Source offsets and 11-bit weights (w0, w1) per destination index, as
    cv2's resize computes them (float32 fractions). `clamp` pins offsets
    that fall off the source with a zero fraction, as cv2 does along x;
    along y it keeps the fraction and clamps the rows read."""
    ofs = np.empty(dsize, np.int64)
    wts = np.empty((dsize, 2), np.int64)
    for d in range(dsize):
        if area:
            s = math.floor(d * scale)
            f = np.float32((d + 1) - (s + 1) * inv_scale)
            f = np.float32(0) if f <= 0 else np.float32(f - np.float32(math.floor(f)))
        else:
            f = np.float32((d + 0.5) * scale - 0.5)
            s = math.floor(f)
            f = np.float32(f - np.float32(s))
        if clamp and s < 0:
            f, s = np.float32(0), 0
        if clamp and s >= ssize - 1:
            f, s = np.float32(0), ssize - 1
        ofs[d] = s
        wts[d] = (int(np.rint(np.float32((np.float32(1) - f) * _COEF_ONE))),
                  int(np.rint(np.float32(f * _COEF_ONE))))
    return ofs, wts


def _resize_linear(img: np.ndarray, w: int, h: int, sx: float, sy: float,
                   area: bool) -> np.ndarray:
    """cv2's fixed-point bilinear for uint8 (INTER_LINEAR, and INTER_AREA
    when an axis grows)."""
    hh, ww, c = img.shape
    xo, xw = _linear_table(ww, w, sx, w / ww, area, clamp=True)
    yo, yw = _linear_table(hh, h, sy, h / hh, area, clamp=False)
    src = img.astype(np.int64)
    x1 = np.minimum(xo + 1, ww - 1)
    rows = src[:, xo] * xw[None, :, 0, None] + src[:, x1] * xw[None, :, 1, None]
    s0 = rows[np.clip(yo, 0, hh - 1)]
    s1 = rows[np.clip(yo + 1, 0, hh - 1)]
    b0, b1 = yw[:, 0, None, None], yw[:, 1, None, None]
    out = ((((s0 >> 4) * b0) >> 16) + (((s1 >> 4) * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size: Tuple[int, int],
           interpolation: str = "linear") -> np.ndarray:
    """`cv2.resize(img, size, interpolation=INTER_LINEAR or INTER_AREA)` for
    a uint8 image (H, W) or (H, W, C); size is (width, height) as cv2
    takes it."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize takes uint8 images, got {img.dtype}")
    if interpolation not in ("linear", "area"):
        raise ValueError(f"interpolation must be 'linear' or 'area', not {interpolation!r}")
    w, h = int(size[0]), int(size[1])
    gray = img.ndim == 2
    x = img[..., None] if gray else img
    sx = 1.0 / (w / x.shape[1])     # cv2's scale: 1 / (dst / src)
    sy = 1.0 / (h / x.shape[0])
    if (w, h) == (x.shape[1], x.shape[0]):
        out = x.copy()
    elif interpolation == "area" and sx >= 1 and sy >= 1:
        kx, ky = int(round(sx)), int(round(sy))
        if abs(sx - kx) < np.finfo(float).eps and abs(sy - ky) < np.finfo(float).eps:
            out = _resize_area_integer(x, w, h, kx, ky)
        else:
            out = _resize_area(x, w, h, sx, sy)
    else:
        out = _resize_linear(x, w, h, sx, sy, area=interpolation == "area")
    return out[..., 0] if gray else out


def _border_value(color: Sequence[float], channels: int) -> np.ndarray:
    """A border colour as cv2 stores it in a uint8 image: each value rounded
    half to even and saturated."""
    vals = np.clip(np.rint(np.asarray(color, np.float64)[:channels]), 0, 255)
    return vals.astype(np.uint8)


def letterbox(img: np.ndarray, height: int,
              color: Tuple[float, float, float] = PAD_COLOR
              ) -> Tuple[np.ndarray, float, float, float]:
    """Aspect-preserving INTER_AREA resize and constant-colour padding to a
    square. Returns (img, ratio, dw, dh)."""
    shape = img.shape[:2]
    ratio = float(height) / max(shape)
    new_shape = (round(shape[1] * ratio), round(shape[0] * ratio))
    dw = (height - new_shape[0]) / 2
    dh = (height - new_shape[1]) / 2
    top, bottom = round(dh - 0.1), round(dh + 0.1)
    left, right = round(dw - 0.1), round(dw + 0.1)
    small = resize(img, new_shape, interpolation="area")
    c = 1 if small.ndim == 2 else small.shape[2]
    out = np.empty((small.shape[0] + top + bottom, small.shape[1] + left + right)
                   + small.shape[2:], np.uint8)
    out[...] = _border_value(color, c).reshape((c,) if small.ndim == 3 else ())
    out[top:top + small.shape[0], left:left + small.shape[1]] = small
    return out, ratio, dw, dh


def inverse_letterbox_box(bbox: np.ndarray, ratio: float, dw: float,
                          dh: float) -> np.ndarray:
    """Map an xyxy box from letterboxed coords back to the original image."""
    out = bbox.astype(np.float64).copy()
    out[[0, 2]] = (out[[0, 2]] - dw) / ratio
    out[[1, 3]] = (out[[1, 3]] - dh) / ratio
    return out


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 RGB HWC -> float32 normalised (ToTensor + Normalize), kept HWC."""
    return ((img.astype(np.float32) / 255.0) - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """Inverse of normalize_image -> uint8 RGB (for visualization)."""
    out = (img * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# training augmentations: cv2's 8-bit arithmetic in numpy
# ---------------------------------------------------------------------------

_HSV_SHIFT = 12                     # cv2's hsv_shift


def _div_table(num: float) -> np.ndarray:
    """cv2's sdiv / hdiv tables: rint(num / i) for i in 1..255, 0 at 0."""
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        t = np.rint(num / i)
    t[0] = 0
    return t.astype(np.int64)


_SDIV = _div_table(255 << _HSV_SHIFT)
_HDIV = _div_table((180 << _HSV_SHIFT) / 6.0)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(RGB2BGR -> BGR2HSV)` of a uint8 RGB image: cv2's
    integer path (H in [0, 180), S and V in [0, 255])."""
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


# (b, g, r) indices into (v, v(1-s), v(1-sh), v(1-s(1-h))) by sector
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
# cv2 5.0 on x86-64 converts each row's pixels in blocks of this many with
# its vector code and the rest with its scalar code
_HSV_BLOCK = 32


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 a * b + c with the product unrounded (an FMA), in float64:
    the product of two float32 values is exact there."""
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(np.float32)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(HSV2BGR -> BGR2RGB)` of a uint8 HSV image (H, W, 3):
    cv2's float32 path (h * 6/180, s and v / 255, the sector table, with
    FMAs in v (1 - s h) and v (1 - s (1 - h))), each value times 255
    truncated where cv2's vector code converts it (the first
    W // 32 * 32 pixels of a row) and rounded half to even in its scalar
    tail."""
    f = np.float32
    h = hsv[..., 0].astype(f) * f(6.0 / 180.0)
    s = hsv[..., 1].astype(f) * f(1.0 / 255.0)
    v = hsv[..., 2].astype(f) * f(1.0 / 255.0)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f)
    one = f(1.0)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, h, one),
                    v * _fma32(-s, one - h, one)], -1)
    bgr = np.take_along_axis(tab, _SECTOR[sector % 6], axis=-1) * f(255.0)
    vec = np.arange(hsv.shape[-2]) < hsv.shape[-2] // _HSV_BLOCK * _HSV_BLOCK
    out = np.where(vec[:, None], np.trunc(bgr), np.rint(bgr))
    return np.clip(out, 0, 255).astype(np.uint8)[..., ::-1]


def hsv_jitter(img: np.ndarray, rng: np.random.Generator,
               fraction: float = 0.50, legacy_hsv: bool = False) -> np.ndarray:
    """Random saturation and value scaling of a uint8 RGB image. The
    reference draws the saturation factor but never applies it;
    `legacy_hsv=True` keeps that no-op (the factor is still drawn, so the
    draws that follow stay the same)."""
    img_hsv = rgb_to_hsv(img)
    s = img_hsv[:, :, 1].astype(np.float32)
    v = img_hsv[:, :, 2].astype(np.float32)
    a = (rng.random() * 2 - 1) * fraction + 1
    if not legacy_hsv:
        s *= a
    if a > 1:
        np.clip(s, 0, 255, out=s)
    a = (rng.random() * 2 - 1) * fraction + 1
    v *= a
    if a > 1:
        np.clip(v, 0, 255, out=v)
    img_hsv[:, :, 1] = s.astype(np.uint8)
    img_hsv[:, :, 2] = v.astype(np.uint8)
    return hsv_to_rgb(img_hsv)


def horizontal_flip(img: np.ndarray, bbox: np.ndarray, phrase: str
                    ) -> Tuple[np.ndarray, np.ndarray, str]:
    """Mirror the image and the xyxy box, and swap left and right in the
    phrase."""
    w = img.shape[1]
    img = np.ascontiguousarray(img[:, ::-1])
    bbox = bbox.copy()
    bbox[0], bbox[2] = w - bbox[2] - 1, w - bbox[0] - 1
    phrase = (phrase.replace("right", "*&^special^&*")
              .replace("left", "right").replace("*&^special^&*", "left"))
    return img, bbox, phrase


def wrap_points(bbox: np.ndarray, M: np.ndarray, height: int,
                angle: float) -> np.ndarray:
    """Warp an xyxy box through the affine matrix, shrink it by the
    reference's angle-based factor and clip it to the image."""
    points = bbox.astype(np.float64)
    xy = np.ones((4, 3))
    xy[:, :2] = points[[0, 1, 2, 3, 0, 3, 2, 1]].reshape(4, 2)
    xy = (xy @ M.T)[:, :2].reshape(1, 8)
    x = xy[:, [0, 2, 4, 6]]
    y = xy[:, [1, 3, 5, 7]]
    xy = np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, 1).T
    radians = angle * math.pi / 180
    reduction = max(abs(math.sin(radians)), abs(math.cos(radians))) ** 0.5
    cx = (xy[:, 2] + xy[:, 0]) / 2
    cy = (xy[:, 3] + xy[:, 1]) / 2
    w = (xy[:, 2] - xy[:, 0]) * reduction
    h = (xy[:, 3] - xy[:, 1]) * reduction
    xy = np.concatenate((cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)
                        ).reshape(4, 1).T
    np.clip(xy, 0, height, out=xy)
    return xy[0]


def rotation_matrix(center: Tuple[float, float], angle: float,
                    scale: float) -> np.ndarray:
    """`cv2.getRotationMatrix2D` (2 x 3, float64; the centre in float32)."""
    cx, cy = (float(np.float32(c)) for c in center)
    rad = angle * (math.pi / 180)
    alpha, beta = math.cos(rad) * scale, math.sin(rad) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert3(m: np.ndarray) -> np.ndarray:
    """cv2's 3 x 3 `invert` (DECOMP_LU): cofactors times 1 / det, in cv2's
    order of operations."""
    (a, b, c), (d, e, f), (g, h, i) = m.tolist()
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    if det == 0:
        return np.zeros((3, 3))
    r = 1.0 / det
    return np.array([[(e * i - f * h) * r, (c * h - b * i) * r, (b * f - c * e) * r],
                     [(f * g - d * i) * r, (a * i - c * g) * r, (c * d - a * f) * r],
                     [(d * h - e * g) * r, (b * g - a * h) * r, (a * e - b * d) * r]])


def warp_perspective(img: np.ndarray, M: np.ndarray, size: Tuple[int, int],
                     border_value: Sequence[float]) -> np.ndarray:
    """`cv2.warpPerspective(img, M, size, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=...)` of a uint8 (H, W, C)
    image, in the float32 arithmetic of cv2's warp kernels (cv2 >= 4.11):
    M inverted in double and rounded to float32; each destination pixel's
    source coordinate x M0 + (y M1 + M2) (an FMA) divided by its w; the
    four neighbours blended with FMAs, p00 + a (p01 - p00) along x, then
    along y; a neighbour outside the image takes the border colour; the
    result rounded half to even."""
    w, h = int(size[0]), int(size[1])
    src_h, src_w, c = img.shape
    m = _invert3(np.asarray(M, np.float64)).reshape(-1).astype(np.float32)
    x = np.arange(w, dtype=np.float32)[None, :]
    y = np.arange(h, dtype=np.float32)[:, None]

    def coord(i):
        return _fma32(x, m[i], y * m[i + 1] + m[i + 2])

    ww = coord(6)
    sx, sy = coord(0) / ww, coord(3) / ww
    ix, iy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - ix)[..., None], (sy - iy)[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    border = _border_value(border_value, c).astype(np.float32)

    def pixel(yy, xx):
        inside = (yy >= 0) & (yy < src_h) & (xx >= 0) & (xx < src_w)
        px = img[np.clip(yy, 0, src_h - 1), np.clip(xx, 0, src_w - 1)].astype(np.float32)
        return np.where(inside[..., None], px, border)

    p00, p01 = pixel(iy, ix), pixel(iy, ix + 1)
    p10, p11 = pixel(iy + 1, ix), pixel(iy + 1, ix + 1)
    v0 = _fma32(ax, p01 - p00, p00)
    v1 = _fma32(ax, p11 - p10, p10)
    out = np.rint(_fma32(ay, v1 - v0, v0))
    return np.clip(out, 0, 255).astype(np.uint8)


def random_affine(
    img: np.ndarray, bbox: np.ndarray, rng: np.random.Generator,
    degrees: Tuple[float, float] = (-5, 5),
    translate: Tuple[float, float] = (0.10, 0.10),
    scale: Tuple[float, float] = (0.90, 1.10),
    shear: Tuple[float, float] = (-2, 2),
    border_value: Tuple[float, float, float] = PAD_COLOR,
    M: Optional[np.ndarray] = None, angle: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Rotation, scale, translation and shear warp of the image and its
    box, the draws in the JAX package's order. Pass (M, angle) to share
    one transform across a clip."""
    height = max(img.shape[0], img.shape[1])
    if M is None:
        a = rng.random() * (degrees[1] - degrees[0]) + degrees[0]
        s = rng.random() * (scale[1] - scale[0]) + scale[0]
        R = np.eye(3)
        R[:2] = rotation_matrix((img.shape[1] / 2, img.shape[0] / 2), a, s)
        T = np.eye(3)
        T[0, 2] = (rng.random() * 2 - 1) * translate[0] * img.shape[0]
        T[1, 2] = (rng.random() * 2 - 1) * translate[1] * img.shape[1]
        S = np.eye(3)
        S[0, 1] = math.tan((rng.random() * (shear[1] - shear[0]) + shear[0])
                           * math.pi / 180)
        S[1, 0] = math.tan((rng.random() * (shear[1] - shear[0]) + shear[0])
                           * math.pi / 180)
        M = S @ T @ R
        angle = a
    imw = warp_perspective(img, M, (height, height), border_value)
    new_bbox = wrap_points(bbox, M, height, angle)
    return imw, new_bbox, M, angle


# The reference's resize transforms that no DCNet path calls, kept for API
# parity with the JAX package.


def resize_pad(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Aspect-preserving INTER_LINEAR resize + centre zero-padding to
    (h, w). Grayscale inputs come back HW1, colour HWC."""
    out_h, out_w = size
    h, w = img.shape[:2]
    scale = min(out_h / h, out_w / w)
    rh, rw = int(np.round(h * scale)), int(np.round(w * scale))
    pad_h, pad_w = (out_h - rh) // 2, (out_w - rw) // 2
    resized = resize(img, (rw, rh), interpolation="linear")
    if img.ndim <= 2:
        resized = resized[..., None]
    out = np.zeros((out_h, out_w, resized.shape[-1]), resized.dtype)
    out[pad_h:pad_h + rh, pad_w:pad_w + rw] = resized
    return out


def _bilinear(x, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the last two axes to `size` (half-pixel centres,
    a triangle filter widened when shrinking), as `jax.image.resize(...,
    method="bilinear")` computes it."""
    x = torch.as_tensor(x)
    lead = x.shape[:-2]
    flat = x.reshape(-1, 1, *x.shape[-2:]).float()
    out = F.interpolate(flat, size=tuple(size), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.reshape(*lead, *size)


def crop_resize(img, size: Tuple[int, int]) -> torch.Tensor:
    """Undo resize_pad on a 2-D map: bilinear resize by the larger ratio,
    then centre-crop to (h, w)."""
    img = torch.as_tensor(img)
    in_h, in_w = size
    im_h, im_w = img.shape[:2]
    scale = max(in_h / im_h, in_w / im_w)
    rh, rw = int(np.round(im_h * scale)), int(np.round(im_w * scale))
    crop_h, crop_w = (rh - in_h) // 2, (rw - in_w) // 2
    resized = _bilinear(img, (rh, rw))
    return resized[crop_h:crop_h + in_h, crop_w:crop_w + in_w]


def resize_image(img, size: int) -> torch.Tensor:
    """Scale a CHW tensor so its larger side equals `size`, bilinear."""
    img = torch.as_tensor(img)
    im_h, im_w = img.shape[-2:]
    scale = min(size / im_h, size / im_w)
    rh, rw = int(np.round(im_h * scale)), int(np.round(im_w * scale))
    return _bilinear(img, (rh, rw))


def resize_annotation(ann, size: int) -> torch.Tensor:
    """resize_image for a 2-D annotation map."""
    ann = torch.as_tensor(ann)
    im_h, im_w = ann.shape[-2:]
    scale = min(size / im_h, size / im_w)
    rh, rw = int(np.round(im_h * scale)), int(np.round(im_w * scale))
    return _bilinear(ann, (rh, rw))
