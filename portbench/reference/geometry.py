"""The model's geometry as the benchmark states it: widths, grids, anchors
and the YOLOv3 layer list, read from a configuration file of
`portbench/configs/`. Plain data; the reference and the work counts read
it, the harness builds the program's own configuration from the same file.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

# COCO k-means anchors at 416 px, small to large; reversed so that index
# 0..2 serve the coarsest scale (/32), as YOLOv3's mask order does
COCO_ANCHORS = ((10, 13), (16, 30), (33, 23), (30, 61), (62, 45),
                (59, 119), (116, 90), (156, 198), (373, 326))

CONV_TYPES = ("convolutional", "yoloconvolutional")


@dataclasses.dataclass(frozen=True)
class Layer:
    """One block of a Darknet cfg after [net]."""

    type: str
    filters: int = 0
    size: int = 0
    stride: int = 1
    pad: int = 0
    bn: bool = False
    leaky: bool = False
    layers: Tuple[int, ...] = ()   # route sources (relative or absolute)
    from_: int = 0                 # shortcut source
    in_ch: int = 0
    out_ch: int = 0


@dataclasses.dataclass(frozen=True)
class Bert:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class Geometry:
    image_size: int = 256
    anchor_imsize: int = 416
    emb_size: int = 512
    query_len: int = 20
    n_frames_test: int = 5
    n_frames_train: int = 2
    text_encoder: str = "bilstm"     # or "bert"
    corpus_size: int = 1000
    word_embedding_size: int = 512
    lstm_hidden: int = 512
    bert: Optional[Bert] = None
    coattn_temperature: float = 10.0
    backbone: str = "yolov3"         # or "mini" (tests)
    # training
    interframe_top_k: int = 30
    interframe_neg_n: int = 10
    crossmodal_top_k: int = 1
    crossmodal_neg_n: int = 5
    infonce_temperature: float = 0.07
    w_rank: float = 100.0
    w_interframe: float = 100.0
    w_crossmodal: float = 1.0
    w_loc: float = 1.0
    yolo_coord_weight: float = 5.0
    rank_margin: float = 0.1
    lr: float = 1e-4
    backbone_lr_scale: float = 0.1
    weight_decay: float = 5e-4
    rmsprop_alpha: float = 0.99
    rmsprop_eps: float = 1e-8
    jemb_dropout: float = 0.1
    input_dropout: float = 0.2

    @property
    def textdim(self) -> int:
        return 2 * self.lstm_hidden if self.text_encoder == "bilstm" else self.bert.hidden_size

    @property
    def strides(self) -> Tuple[int, ...]:
        return (32, 16, 8)

    @property
    def grids(self) -> Tuple[int, ...]:
        return tuple(self.image_size // s for s in self.strides)

    @property
    def all_positions(self) -> int:
        return sum(g * g for g in self.grids)

    def anchors(self) -> Tuple[Tuple[float, float], ...]:
        return tuple(reversed(COCO_ANCHORS))

    def scaled_anchors(self, scale: int) -> Tuple[Tuple[float, float], ...]:
        """The scale's three anchors in cells of its grid."""
        ratio = self.anchor_imsize / self.grids[scale]
        return tuple((w / ratio, h / ratio) for w, h in self.anchors()[3 * scale:3 * scale + 3])

    def layers(self) -> Tuple[Layer, ...]:
        return yolov3_layers() if self.backbone == "yolov3" else mini_layers()

    def sampling(self) -> Tuple[int, int, int]:
        """(interframe top-k, interframe negatives, crossmodal negatives),
        clamped to what the coarsest grid offers."""
        p = self.grids[0] ** 2
        return (min(self.interframe_top_k, p * p), min(self.interframe_neg_n, max(p - 1, 1)),
                min(self.crossmodal_neg_n, max(p - 1, 1)))


_GEOMETRY_KEYS = {f.name for f in dataclasses.fields(Geometry)}


def geometry_from(config: dict, **overrides) -> Geometry:
    """A Geometry from a configuration file's dict (keys it does not name
    keep their defaults; `bert` is a nested group)."""
    kw = {k: v for k, v in {**config, **overrides}.items() if k in _GEOMETRY_KEYS}
    if kw.get("bert") is not None and not isinstance(kw["bert"], Bert):
        kw["bert"] = Bert(**kw["bert"])
    return Geometry(**kw)


def load_geometry(path: str, **overrides) -> Geometry:
    with open(path) as f:
        return geometry_from(json.load(f), **overrides)


def _build(blocks: List[dict]) -> Tuple[Layer, ...]:
    out_ch = [3]
    layers: List[Layer] = []
    for b in blocks:
        t = b["type"]
        if t in CONV_TYPES:
            ly = Layer(t, b["filters"], b["size"], b["stride"], (b["size"] - 1) // 2,
                       b["bn"], b["leaky"], in_ch=out_ch[-1], out_ch=b["filters"])
        elif t == "upsample":
            ly = Layer(t, stride=2, out_ch=out_ch[-1])
        elif t == "route":
            ly = Layer(t, layers=b["layers"], out_ch=sum(out_ch[1:][s] for s in b["layers"]))
        elif t == "shortcut":
            ly = Layer(t, from_=b["from"], out_ch=out_ch[1:][b["from"]])
        else:  # yolo: a placeholder that keeps route indices aligned
            ly = Layer(t, out_ch=out_ch[-1])
        layers.append(ly)
        out_ch.append(ly.out_ch)
    return tuple(layers)


def _conv(blocks, filters, size, stride=1, t="convolutional", bn=True, leaky=True):
    blocks.append(dict(type=t, filters=filters, size=size, stride=stride, bn=bn, leaky=leaky))


def yolov3_layers(num_classes: int = 80) -> Tuple[Layer, ...]:
    """YOLOv3 (`yolov3.cfg`): Darknet-53 and the three-scale head, whose
    third 1x1 conv of each scale is `yoloconvolutional`: its input is the
    map the grounding model captures (1024 @ /32, 512 @ /16, 256 @ /8)."""
    blocks: List[dict] = []
    _conv(blocks, 32, 3)
    for out, n in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
        _conv(blocks, out, 3, 2)
        for _ in range(n):
            _conv(blocks, out // 2, 1)
            _conv(blocks, out, 3)
            blocks.append(dict(type="shortcut", **{"from": -3}))
    det = 3 * (5 + num_classes)
    for s, (mid, out) in enumerate(((512, 1024), (256, 512), (128, 256))):
        if s > 0:
            blocks.append(dict(type="route", layers=(-4,)))
            _conv(blocks, mid, 1)
            blocks.append(dict(type="upsample"))
            blocks.append(dict(type="route", layers=(-1, (61, 36)[s - 1])))
        for _ in range(2):
            _conv(blocks, mid, 1)
            _conv(blocks, out, 3)
        _conv(blocks, mid, 1, t="yoloconvolutional")
        _conv(blocks, out, 3)
        _conv(blocks, det, 1, bn=False, leaky=False)
        blocks.append(dict(type="yolo"))
    return _build(blocks)


def mini_layers() -> Tuple[Layer, ...]:
    """A five-layer stand-in with YOLOv3's capture layout, for CPU tests."""
    blocks: List[dict] = []
    for f in (8, 16, 24, 32, 48):
        _conv(blocks, f, 3, 2)
    _conv(blocks, 16, 1, t="yoloconvolutional")
    blocks.append(dict(type="upsample"))
    blocks.append(dict(type="route", layers=(-1, 3)))
    _conv(blocks, 16, 1, t="yoloconvolutional")
    blocks.append(dict(type="upsample"))
    blocks.append(dict(type="route", layers=(-1, 2)))
    _conv(blocks, 8, 1, t="yoloconvolutional")
    return _build(blocks)


def sources(i: int, ly: Layer) -> List[int]:
    """The layers whose outputs layer i reads (-1: the image)."""
    if ly.type == "route":
        return [s if s >= 0 else i + s for s in ly.layers]
    if ly.type == "shortcut":
        return [i - 1, ly.from_ if ly.from_ >= 0 else i + ly.from_]
    return [i - 1]


def live(layers) -> set:
    """Layers whose outputs reach a captured map (the input of a
    `yoloconvolutional` conv)."""
    need = {j - 1 for j, ly in enumerate(layers) if ly.type == "yoloconvolutional"}
    for i in range(len(layers) - 1, -1, -1):
        if i in need:
            need.update(sources(i, layers[i]))
    return need


def conv_shapes(layers, size: int) -> List[Tuple[int, int, int, int, int, int, int]]:
    """(layer, k, stride, pad, Ci, Co, input side) of every conv at size x size."""
    sides: List[int] = []
    side, out = size, []
    for i, ly in enumerate(layers):
        if ly.type in CONV_TYPES:
            out.append((i, ly.size, ly.stride, ly.pad, ly.in_ch, ly.filters, side))
            side = (side + 2 * ly.pad - ly.size) // ly.stride + 1
        elif ly.type == "upsample":
            side *= 2
        elif ly.type == "route":
            side = sides[sources(i, ly)[0]]
        sides.append(side)
    return out
