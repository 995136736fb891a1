"""Single-image referring-expression datasets (ReferIt, Flickr, RefCOCO
family, OTB) for evaluation: the port of `dcnet_tpu/data/referit.py` in
test mode, on the frame reader of `data/vid.py`.

RefCOCO-family boxes (unc, unc+, gref) arrive as xywh and are converted to
xyxy. Index: the reference's `{dataset}_{split}.pth` torch pickle or a JSON
list with the same per-entry tuples. The training augmentations (ROADMAP
queue A, item 11), the BERT tokenizer (item 10) and the C++ host loader
(item 13) raise.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from dcnet_tpu_torch import not_ported
from dcnet_tpu_torch.data import transforms as T
from dcnet_tpu_torch.data.corpus import Corpus
from dcnet_tpu_torch.data.vid import load_index, read_image

_XYWH_DATASETS = {"unc", "unc+", "gref"}


class ReferItDataset:
    def __init__(
        self, index_path: str, corpus: Optional[Corpus],
        dataset: str = "referit", imsize: int = 256, max_query_len: int = 20,
        augment: bool = False, testmode: bool = False, image_root: str = "",
        seed: int = 13, bert_tokenizer: Optional[Any] = None,
        use_native: Optional[bool] = None,
    ):
        if corpus is None or bert_tokenizer is not None:
            raise not_ported("the BERT tokenizer", "ROADMAP queue A, item 10")
        if augment:
            raise not_ported("the training augmentations", "ROADMAP queue A, item 11")
        if use_native:
            raise not_ported("the C++ host loader (use_native=True)",
                             "ROADMAP queue A, item 13")
        self.entries = load_index(index_path)
        self.dataset = dataset
        self.imsize = imsize
        self.query_len = max_query_len
        self.corpus = corpus
        self.testmode = testmode
        self.image_root = image_root

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
        img_file, bbox, phrase = self._unpack(self.entries[int(idx)])
        phrase = phrase.lower()
        img = read_image(os.path.join(self.image_root, img_file))
        img, ratio, dw, dh = T.letterbox(img, self.imsize)
        bbox[[0, 2]] = bbox[[0, 2]] * ratio + dw
        bbox[[1, 3]] = bbox[[1, 3]] * ratio + dh
        word_ids = self.corpus.tokenize(phrase, self.query_len)
        out = {
            "images": T.normalize_image(img)[None].astype(np.float32),  # (1,H,W,3)
            "word_ids": word_ids[None].astype(np.int32),
            "word_mask": np.zeros_like(word_ids)[None].astype(np.int32),
            "bbox": bbox[None].astype(np.float32),
        }
        if self.testmode:
            out["ratio"] = np.asarray([ratio], np.float32)
            out["dw"] = np.asarray([dw], np.float32)
            out["dh"] = np.asarray([dh], np.float32)
            out["paths"] = [img_file]
            out["phrases"] = [phrase]
        return out
