"""Typed configuration of the port: the eval and training fields of the JAX
package's `DCNetConfig` and every shape derived from them.

The port's own copy of `dcnet_tpu/config.py` (anchor tables, the
`legacy_anchor_typo` switch, strides, grids, all_positions, scaled anchors,
scale and position offsets, the clamping of the correspondence sizes); the
TPU-only fields are not carried. Options the port does not run yet are kept
as fields so a config reads the same in both packages, and raise where they
would take effect.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# k-means anchors at anchor_imsize=416, small -> large as listed; reversed so
# index 0..2 = coarsest scale (/32), 3..5 = /16, 6..8 = /8.
_ANCHOR_TABLES = {
    "referit": (
        (30, 36), (78, 46), (48, 86), (149, 79), (82, 148),
        (331, 93), (156, 207), (381, 163), (329, 285),
    ),
    "flickr": (
        (29, 26), (55, 58), (137, 71), (82, 121), (124, 205),
        (204, 132), (209, 263), (369, 169), (352, 294),
    ),
    # COCO anchors: default for VID / unc / unc+ / gref / everything else.
    "coco": (
        (10, 13), (16, 30), (33, 23), (30, 61), (62, 45),
        (59, 119), (116, 90), (156, 198), (373, 326),
    ),
}

NUM_SCALES = 3
ANCHORS_PER_SCALE = 3
BOX_ATTRS = 5  # tx, ty, tw, th, conf


def anchors_for_dataset(dataset: str, legacy_anchor_typo: bool = False
                        ) -> Tuple[Tuple[float, float], ...]:
    """The 9 (w, h) anchors, reversed so anchors[0:3] serve scale /32.
    `legacy_anchor_typo=True` sends 'referit' to the COCO table, as the
    original training script's 'refeit' misspelling did."""
    if dataset == "flickr":
        table = _ANCHOR_TABLES["flickr"]
    elif dataset == "referit" and not legacy_anchor_typo:
        table = _ANCHOR_TABLES["referit"]
    else:
        table = _ANCHOR_TABLES["coco"]
    return tuple(reversed(table))


@dataclasses.dataclass(frozen=True)
class DCNetConfig:
    """One typed config; every derived shape is computed here."""

    dataset: str = "VID"
    image_size: int = 256
    anchor_imsize: int = 416
    emb_size: int = 512
    query_len: int = 20
    n_frames_train: int = 2        # train clip length (k=2: the pair kernel)
    n_frames_test: int = 5
    light: bool = False
    use_lstm: bool = True          # False = BERT text encoder (not ported)
    corpus_size: int = 0           # vocab size when use_lstm
    lstm_hidden: int = 512
    word_embedding_size: int = 512
    jemb_dropout: float = 0.1
    input_dropout: float = 0.2
    # correspondence sampling (clamped to the coarsest grid in __post_init__)
    interframe_top_k: int = 30
    interframe_neg_n: int = 10
    crossmodal_top_k: int = 1
    crossmodal_neg_n: int = 5
    coattn_temperature: float = 10.0
    infonce_temperature: float = 0.07
    # loss weights
    w_rank: float = 100.0
    w_interframe: float = 100.0
    w_crossmodal: float = 1.0
    w_loc: float = 1.0
    yolo_coord_weight: float = 5.0
    rank_margin: float = 0.1
    # optimizer: two parameter groups, the backbone at lr * backbone_lr_scale,
    # poly decay per epoch
    lr: float = 1e-4
    backbone_lr_scale: float = 0.1
    weight_decay: float = 5e-4
    poly_power: float = 0.9
    nb_epoch: int = 100
    batch_size: int = 8
    optimizer: str = "rmsprop"     # or "adam", "sgd"
    seed: int = 13
    legacy_anchor_typo: bool = False
    compute_dtype: str = "float32"  # or "bfloat16"
    split_corr_conv: bool = True    # corr_conv computes the center half once
    coattn_batch_refs: bool = False   # not ported yet (ROADMAP queue A, 9)
    coattn_multiref: bool = False     # center vs every reference in one K4 launch
    coattn_int8_logits: bool = False  # not ported yet (ROADMAP queue A, 9)
    trunk_quant: str = "off"          # not ported yet (ROADMAP queue A, 9)
    remat_backbone: bool = False      # not ported yet (ROADMAP queue A, 6)
    tp_internals: bool = False        # not ported yet (ROADMAP queue A, 12)

    def __post_init__(self):
        # the reference constants 30/10/5 assume 64 patches on the coarsest
        # grid (256 px); smaller images offer fewer
        p = (self.image_size // 32) ** 2
        object.__setattr__(self, "interframe_top_k",
                           min(self.interframe_top_k, p * p))
        object.__setattr__(self, "interframe_neg_n",
                           min(self.interframe_neg_n, max(p - 1, 1)))
        object.__setattr__(self, "crossmodal_neg_n",
                           min(self.crossmodal_neg_n, max(p - 1, 1)))

    def replace(self, **changes) -> "DCNetConfig":
        return dataclasses.replace(self, **changes)

    @property
    def textdim(self) -> int:
        return 2 * self.lstm_hidden  # BiLSTM output width

    @property
    def strides(self) -> Tuple[int, ...]:
        return (32, 16, 8)  # scale 0 = coarsest

    @property
    def grids(self) -> Tuple[int, ...]:
        return tuple(self.image_size // s for s in self.strides)

    @property
    def all_positions(self) -> int:
        """Sum of grid**2 over scales (1344 at 256 px)."""
        return sum(g * g for g in self.grids)

    @property
    def anchors_full(self) -> Tuple[Tuple[float, float], ...]:
        return anchors_for_dataset(self.dataset, self.legacy_anchor_typo)

    def scaled_anchors(self, scale: int) -> Tuple[Tuple[float, float], ...]:
        """Anchors of `scale`, rescaled from anchor_imsize to that grid."""
        ratio = self.anchor_imsize / self.grids[scale]
        sel = self.anchors_full[3 * scale: 3 * scale + 3]
        return tuple((w / ratio, h / ratio) for w, h in sel)

    def scale_offsets(self) -> Tuple[int, ...]:
        """Start of each scale inside the flat 3*grid^2 conf vector."""
        offs, acc = [], 0
        for g in self.grids:
            offs.append(acc)
            acc += ANCHORS_PER_SCALE * g * g
        return tuple(offs)

    def position_offsets(self) -> Tuple[int, ...]:
        """Start of each scale inside the flat grid^2 position vector (the
        all_positions-long layout of the sim/loc score maps)."""
        offs, acc = [], 0
        for g in self.grids:
            offs.append(acc)
            acc += g * g
        return tuple(offs)
