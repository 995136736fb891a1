"""Single-image referring-expression datasets (ReferIt, Flickr, RefCOCO
family, OTB): the port of `dcnet_tpu/data/referit.py` on the frame
reader, tokenizers and augmentations of `data/vid.py`.

RefCOCO-family boxes (unc, unc+, gref) arrive as xywh and are converted to
xyxy. Index: the reference's `{dataset}_{split}.pth` torch pickle or a JSON
list with the same per-entry tuples. `augment=True` flips, jitters,
letterboxes and warps as the JAX package does, from a stream seeded by
(seed, epoch, index). `use_native` takes the C++ host loader as
`VIDDataset` does (`native.use_core`): its fused letterbox for an
untransformed image, its decode for an augmented one.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from dcnet_tpu_torch.data import transforms as T
from dcnet_tpu_torch.data.corpus import Corpus
from dcnet_tpu_torch.data.vid import (
    decode_frames, item_rng, letterbox_box, letterbox_frames, load_index, move_box,
    tokenize)

_XYWH_DATASETS = {"unc", "unc+", "gref"}


class ReferItDataset:
    def __init__(
        self, index_path: str, corpus: Optional[Corpus],
        dataset: str = "referit", imsize: int = 256, max_query_len: int = 20,
        augment: bool = False, testmode: bool = False, image_root: str = "",
        seed: int = 13, bert_tokenizer: Optional[Any] = None,
        legacy_hsv: bool = False, use_native: Optional[bool] = None,
    ):
        if corpus is None and bert_tokenizer is None:
            raise ValueError("ReferItDataset needs a corpus or a BERT tokenizer")
        self.use_native = use_native
        self.entries = load_index(index_path)
        self.dataset = dataset
        self.imsize = imsize
        self.query_len = max_query_len
        self.corpus = corpus
        self.bert_tokenizer = bert_tokenizer
        self.augment = augment
        self.legacy_hsv = legacy_hsv
        self.testmode = testmode
        self.image_root = image_root
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Re-draw the augmentation streams."""
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.entries)

    def _unpack(self, entry) -> Tuple[str, np.ndarray, str]:
        if len(entry) >= 5:      # refcoco family: (img, mask, bbox, phrase, attri)
            img_file, bbox, phrase = entry[0], entry[2], entry[3]
        else:                     # referit/flickr/VID/OTB: (img, bbox, phrase)
            img_file, bbox, phrase = entry[0], entry[1], entry[2]
        bbox = np.array(bbox, np.float64)  # a copy: the index stays as read
        if self.dataset in _XYWH_DATASETS:
            bbox[2] += bbox[0]
            bbox[3] += bbox[1]
        return img_file, bbox, str(phrase)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        idx = int(idx)
        img_file, bbox, phrase = self._unpack(self.entries[idx])
        phrase = phrase.lower()
        ori_phrase = phrase
        full = [os.path.join(self.image_root, img_file)]
        if self.augment:
            img = decode_frames(full, self.use_native)[0]
            rng = item_rng(self.seed, self._epoch, idx)
            if rng.random() > 0.5:
                img, bbox, phrase = T.horizontal_flip(img, bbox, phrase)
            img = T.hsv_jitter(img, rng, legacy_hsv=self.legacy_hsv)
            img, ratio, dw, dh = letterbox_box(img, bbox, self.imsize)
            img, bbox, _, _ = T.random_affine(img, bbox, rng)
            images = T.normalize_image(img)[None].astype(np.float32)
        else:
            images, (ratio,), (dw,), (dh,) = letterbox_frames(full, self.imsize,
                                                              self.use_native)
            move_box(bbox, ratio, dw, dh)
        word_ids, word_mask = tokenize(phrase, self.query_len, self.corpus,
                                       self.bert_tokenizer)
        out = {
            "images": images,                                   # (1,H,W,3)
            "word_ids": word_ids[None].astype(np.int32),
            "word_mask": word_mask[None].astype(np.int32),
            "bbox": bbox[None].astype(np.float32),
        }
        if self.testmode:
            out["ratio"] = np.asarray([ratio], np.float32)
            out["dw"] = np.asarray([dw], np.float32)
            out["dh"] = np.asarray([dh], np.float32)
            out["paths"] = [img_file]
            out["phrases"] = [ori_phrase]
        return out
