"""VID video-clip grounding dataset and host input pipeline: the port of
`dcnet_tpu/data/vid.py`.

- `get_chunks`: sliding windows of `num_frame_k` consecutive frames around
  each center index (train picks one random annotation track per video).
- `VIDDataset`: decode -> (train: shared flip, per-frame HSV jitter and
  letterbox, per-frame random affine) -> normalize -> tokenize (the
  corpus, or BERT's `encode_phrase`), plus in test mode (ratio, dw, dh,
  video id, paths, phrases) per frame.
- `batch_iterator`: batches with per-host sharding and optional decode
  threads; `prefetch_to_device`: a background thread that
  copies batches from pinned host memory to the card without blocking.

Frames are read by their extension (`read_image`): `.npy` with numpy, any
other image file through cv2, which raises a `RuntimeError` naming cv2
where it is not installed. The augmentations are numpy copies of cv2's
arithmetic (`data/transforms.py`). `use_native` takes the C++ host loader
(`dcnet_tpu_torch.native`, its rule in `native.use_core`): untransformed
clips through its fused decode + letterbox + normalize of every frame in
one call, augmented ones through its parallel decode, with equal pixels.

Index formats: the reference's torch-pickled `VID_video_level_{split}.pth`
or a JSON file with the same nesting:
train: [video][track][frame] = [img_path, [x1,y1,x2,y2], phrase]
test:  [video][frame] = [img_path, [x1,y1,x2,y2], phrase]
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from dcnet_tpu_torch import native
from dcnet_tpu_torch.data import transforms as T
from dcnet_tpu_torch.data.bert_tokenize import encode_phrase
from dcnet_tpu_torch.data.corpus import Corpus

# (frame paths, boxes, phrases, video index): the video index keeps temporal
# fusion inside one video
Chunk = Tuple[List[str], List[np.ndarray], List[str], int]


def load_index(path: str) -> List:
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    return torch.load(path, map_location="cpu", weights_only=False)


def read_image(path: str) -> np.ndarray:
    """A frame as uint8 RGB (H, W, 3): `.npy` arrays (RGB, or gray (H, W))
    with numpy, every other image file through cv2."""
    if path.endswith(".npy"):
        img = np.load(path)
        if img.dtype != np.uint8:
            raise ValueError(f"{path}: frames are uint8, got {img.dtype}")
    else:
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError(
                f"decoding {os.path.basename(path)} needs cv2 (OpenCV), which "
                f"is not installed; store the frames as .npy arrays") from e
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        if img.ndim == 3 and img.shape[-1] == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.ndim == 2 or img.shape[-1] == 1:
        img = np.stack([np.squeeze(img)] * 3, axis=-1)
    return img


def get_chunks(videos: List, split: str, num_frame_k: int,
               rng: Optional[np.random.Generator] = None) -> List[Chunk]:
    """Sliding window of `num_frame_k` consecutive frames per center index.
    Train picks one random track per video."""
    rng = rng or np.random.default_rng(0)
    num_floor = int(math.floor(num_frame_k / 2))
    num_ceil = int(math.ceil(num_frame_k / 2))
    chunks: List[Chunk] = []
    for video_id, vid in enumerate(videos):
        track = vid[int(rng.integers(0, len(vid)))] if split == "train" else vid
        n = len(track)
        for center in range(n):
            if center - num_floor < 0 or center + num_ceil > n - 1:
                continue
            paths, boxes, phrases = [], [], []
            for i in range(center - num_floor, center + num_ceil):
                f = track[int(np.clip(i, 0, n - 1))]
                paths.append(f[0])
                boxes.append(np.asarray(f[1], np.float64))
                phrases.append(str(f[2]))
            chunks.append((paths, boxes, phrases, video_id))
    return chunks


def item_rng(seed: int, epoch: int, idx: int) -> np.random.Generator:
    """The augmentation stream of one item in one epoch."""
    return np.random.default_rng((seed * 1_000_003 + epoch * 10_007 + idx) % (2 ** 63))


def tokenize(phrase: str, query_len: int, corpus: Optional[Corpus],
             bert_tokenizer: Optional[Any]) -> Tuple[np.ndarray, np.ndarray]:
    """(word ids, word mask) of a phrase: the corpus's ids with a zero
    mask, or BERT's `encode_phrase`."""
    if corpus is not None:
        ids = corpus.tokenize(phrase, query_len)
        return ids, np.zeros_like(ids)
    return encode_phrase(bert_tokenizer, phrase, query_len)


def move_box(bbox: np.ndarray, ratio: float, dw: float, dh: float) -> None:
    """Move an xyxy box into its letterboxed frame, in place."""
    bbox[[0, 2]] = bbox[[0, 2]] * ratio + dw
    bbox[[1, 3]] = bbox[[1, 3]] * ratio + dh


def letterbox_box(img: np.ndarray, bbox: np.ndarray, imsize: int):
    """Letterbox one frame and move its xyxy box with it, in place:
    returns (img, ratio, dw, dh)."""
    img, ratio, dw, dh = T.letterbox(img, imsize)
    move_box(bbox, ratio, dw, dh)
    return img, ratio, dw, dh


def decode_frames(paths: List[str], use_native: Optional[bool]) -> List[np.ndarray]:
    """uint8 RGB frames: through the host loader's parallel decode where
    `native.use_core` takes it, else `read_image` one by one."""
    if not native.use_core(use_native, paths):
        return [read_image(p) for p in paths]
    imgs = native.decode_batch_rgb(paths)
    for p, img in zip(paths, imgs):
        if img is None:
            raise native.decode_failed(p)
    return imgs


def letterbox_frames(paths: List[str], imsize: int, use_native: Optional[bool]):
    """Letterboxed, normalized frames (n, imsize, imsize, 3) float32 and
    their (ratios, dws, dhs): one host loader call where `native.use_core`
    takes it, else read_image -> letterbox -> normalize_image frame by
    frame. The two give equal arrays and geometry."""
    if native.use_core(use_native, paths):
        images, ratios, dws, dhs, ok = native.decode_letterbox_batch(
            paths, imsize, T.IMAGENET_MEAN, T.IMAGENET_STD)
        if not ok.all():
            raise native.decode_failed(paths[int(np.argmin(ok))])
        return images, [float(r) for r in ratios], [float(w) for w in dws], \
            [float(h) for h in dhs]
    imgs, ratios, dws, dhs = [], [], [], []
    for p in paths:
        img, ratio, dw, dh = T.letterbox(read_image(p), imsize)
        imgs.append(T.normalize_image(img))
        ratios.append(ratio); dws.append(dw); dhs.append(dh)
    return np.stack(imgs).astype(np.float32), ratios, dws, dhs


class VIDDataset:
    """Map-style clip dataset. `__getitem__` returns numpy arrays ready to
    stack into a batch. The train split augments by default: a flip shared
    by the clip (with the left/right phrase swap), then per frame HSV
    jitter and letterbox, then per frame a random affine warp, drawn from
    a stream seeded by (seed, epoch, index) in the JAX package's order."""

    def __init__(
        self, index_path: str, corpus: Optional[Corpus], split: str = "train",
        imsize: int = 256, num_frame_k: int = 2, max_query_len: int = 20,
        augment: Optional[bool] = None, testmode: bool = False,
        image_root: str = "", seed: int = 13,
        bert_tokenizer: Optional[Any] = None, legacy_hsv: bool = False,
        use_native: Optional[bool] = None,
    ):
        if corpus is None and bert_tokenizer is None:
            raise ValueError("VIDDataset needs a corpus or a BERT tokenizer")
        self.use_native = use_native
        self.augment = (split == "train") if augment is None else augment
        self.legacy_hsv = legacy_hsv
        self.imsize = imsize
        self.k = num_frame_k
        self.query_len = max_query_len
        self.corpus = corpus
        self.bert_tokenizer = bert_tokenizer
        self.testmode = testmode
        self.image_root = image_root
        self.seed = seed
        self.split = split
        self._videos = load_index(index_path)
        self.set_epoch(0)

    def set_epoch(self, epoch: int) -> None:
        """Re-draw the random track picks and the augmentation streams."""
        rng = np.random.default_rng(self.seed + epoch)
        self.chunks = get_chunks(self._videos, self.split, self.k, rng)
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.chunks)

    def _read_image(self, path: str) -> np.ndarray:
        return read_image(os.path.join(self.image_root, path))

    def _tokenize(self, phrase: str) -> Tuple[np.ndarray, np.ndarray]:
        return tokenize(phrase, self.query_len, self.corpus, self.bert_tokenizer)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        idx = int(idx)
        paths, bboxs, phrases, video_id = self.chunks[idx]
        bboxs = [b.copy() for b in bboxs]
        phrases = [p.lower() for p in phrases]
        ori_phrases = list(phrases)
        full = [os.path.join(self.image_root, p) for p in paths]
        if self.augment:
            imgs = decode_frames(full, self.use_native)
            rng = item_rng(self.seed, self._epoch, idx)
            if rng.random() > 0.5:  # one flip for the clip
                for i in range(self.k):
                    imgs[i], bboxs[i], phrases[i] = T.horizontal_flip(
                        imgs[i], bboxs[i], phrases[i])
            ratios, dws, dhs = [], [], []
            for i in range(self.k):  # per-frame HSV jitter, letterbox, then affine
                imgs[i] = T.hsv_jitter(imgs[i], rng, legacy_hsv=self.legacy_hsv)
                imgs[i], ratio, dw, dh = letterbox_box(imgs[i], bboxs[i], self.imsize)
                ratios.append(ratio); dws.append(dw); dhs.append(dh)
            for i in range(self.k):
                imgs[i], bboxs[i], _, _ = T.random_affine(imgs[i], bboxs[i], rng)
            images = np.stack([T.normalize_image(im) for im in imgs]).astype(np.float32)
        else:
            images, ratios, dws, dhs = letterbox_frames(full, self.imsize, self.use_native)
            for i in range(self.k):
                move_box(bboxs[i], ratios[i], dws[i], dhs[i])
        ids_masks = [self._tokenize(p) for p in phrases]
        out = {
            "images": images,                                # (k, H, W, 3)
            "word_ids": np.stack([im[0] for im in ids_masks]).astype(np.int32),
            "word_mask": np.stack([im[1] for im in ids_masks]).astype(np.int32),
            "bbox": np.stack(bboxs).astype(np.float32),
        }
        if self.testmode:
            out["ratio"] = np.asarray(ratios, np.float32)
            out["dw"] = np.asarray(dws, np.float32)
            out["dh"] = np.asarray(dhs, np.float32)
            out["video_id"] = np.asarray(video_id, np.int32)
            out["paths"] = paths
            out["phrases"] = ori_phrases
        return out


def batch_iterator(
    dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
    drop_last: bool = True, num_shards: int = 1, shard_index: int = 0,
    num_workers: int = 0, batch_shards: int = 1, batch_shard: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Host batch iterator with per-host sharding (`num_shards`: each shard
    batches its own interleaved share of the clips) or per-rank batch
    slices (`batch_shards`: every shard walks the global batches of
    `batch_size`, drop_last, and yields rows `batch_shard` * b to
    (`batch_shard` + 1) * b of each, b = batch_size / batch_shards, the
    rows a data-parallel step places on that rank; every shard takes
    the same len // batch_size steps). num_workers > 0 decodes
    each batch's items in a pool of that many threads (the letterbox's
    numpy passes release the GIL for part of their time). On the 8-core
    host of an NVIDIA H100 80GB HBM3 (700.00 W), cli/test.py's fp32
    standard eval ran 35.5 clips/s with 8 threads, 11.7 serially and 5.9
    with 8 worker processes (`chip_smoke.py --cli-pace`, 384 windows of
    320x480 frames)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    order = order[shard_index::num_shards]
    n = len(order)
    if batch_shards > 1 and (batch_size % batch_shards or not drop_last):
        raise ValueError(f"batch slices need drop_last and a batch of {batch_size} "
                         f"divisible by {batch_shards} shards")
    per = batch_size // batch_shards

    def collate(items):
        out: Dict[str, Any] = {}
        for key in items[0]:
            vals = [it[key] for it in items]
            out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
        return out

    def batches_from(get_many):
        for start in range(0, n, batch_size):
            idxs = order[start:start + batch_size]
            if len(idxs) < batch_size and drop_last:
                break
            idxs = idxs[batch_shard * per:(batch_shard + 1) * per]
            yield collate(get_many([int(i) for i in idxs]))

    if num_workers > 0:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(num_workers) as pool:
            yield from batches_from(
                lambda idxs: list(pool.map(dataset.__getitem__, idxs)))
    else:
        yield from batches_from(lambda idxs: [dataset[i] for i in idxs])


def prefetch_to_device(iterator, device, size: int = 2):
    """Decode ahead and copy to `device` from pinned host memory without
    blocking: a background thread keeps `size` batches in flight. Numeric
    arrays become tensors on `device`; lists pass through."""
    import queue
    import threading

    device = torch.device(device)
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()

    def put(batch):
        dev = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.dtype != object:
                t = torch.from_numpy(np.ascontiguousarray(v))
                if pin:
                    t = t.pin_memory()
                dev[k] = t.to(device, non_blocking=pin)
            else:
                dev[k] = v
        q.put(dev)

    failed = []

    def producer():
        try:
            for batch in iterator:
                put(batch)
        except Exception as e:  # re-raised in the consumer
            failed.append(e)
        finally:
            q.put(end)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            if failed:
                raise failed[0]
            break
        yield item
