"""Streaming multi-query grounding engine: the port of
`dcnet_tpu/serving/engine.py`.

N independent video streams, each with its own referring phrase, are served
in one batched step per tick:

- the backbone runs only on the one new frame of each stream;
- its mapped features go into per-stream feature rings of the last
  `n_frame` frames (float in the model's compute dtype, or int8 with the
  static scale 1/127), written in place into one rotating slot;
- the center frame is grounded off the rings (`DCNet.eval_features` with
  the rotating-ring `newest_slot`; kernel K4 with `cfg.coattn_multiref`,
  K1 per reference without it) against the phrase features cached when the
  phrase arrived;
- a per-stream ring of the last `fuse_window` top-k (box, score, feature)
  tuples feeds the temporal fusion, inside the same step.

Predictions are for the window center, delayed by n_frame // 2 frames, as
in the offline pipeline.

What stands in for JAX: buffer donation becomes in-place ring writes
(`donate_state=True` may overwrite the input state's rings; False leaves
them intact), and the rotating slot is a host integer carried in the state,
so a tick reads no device scalar. The int8 backbone (`quantize()`,
`int8_chain`), the device mesh and XLA compiler options are not carried
(ROADMAP).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dcnet_tpu_torch import DeviceLike, resolve_device
from dcnet_tpu_torch.eval.temporal import build_frame_cache
from dcnet_tpu_torch.models.dcnet import DCNet, _not_ported
from dcnet_tpu_torch.ops.decode import decode_best


class StreamState(NamedTuple):
    """Rings and caches of all streams. Leading dim = n_streams."""

    feat_rings: Tuple[torch.Tensor, ...]  # per scale (N, n_frame, g, g, C)
    cache_boxes: torch.Tensor             # (N, fuse_window, K, 4) fp32
    cache_scores: torch.Tensor            # (N, fuse_window, K) fp32
    cache_feats: torch.Tensor             # (N, fuse_window, K, C)
    frames_seen: torch.Tensor             # (N,) int32
    word_ids: torch.Tensor                # (N, L) each stream's phrase
    language: Tuple[torch.Tensor, ...]    # cached (flang, context, embedded)
    slot: int  # physical ring index of the newest frame (rotate mode);
    #            carried but unused in shift mode


class GroundingEngine:
    """Batched streaming server over a `DCNet`; runs on the model's device
    and stores its rings and caches in the model's compute dtype."""

    def __init__(self, model: DCNet, n_streams: int, n_frame: int = 5,
                 topk: int = 5, fuse_window: int = 5, mesh=None,
                 donate_state: bool = True, rotate_rings: bool = True,
                 int8_rings: bool = False, int8_chain: bool = False,
                 compiler_options=None):
        if int8_chain:
            raise _not_ported("int8_chain (the int8 backbone)",
                              "ROADMAP queue A, item 9")
        if mesh is not None:
            raise _not_ported("a device mesh", "ROADMAP queue A, item 12")
        if compiler_options:
            raise _not_ported("compiler_options (XLA/TPU compiler flags)",
                              "XLA options have no PyTorch counterpart")
        self.model = model
        self.cfg = model.cfg
        self.n_streams = n_streams
        self.n_frame = n_frame
        self.topk = topk
        self.fuse_window = fuse_window
        self.donate_state = donate_state
        self.rotate_rings = rotate_rings
        self.int8_rings = int8_rings
        self.state_dtype = model.dtype
        self.ring_dtype = torch.int8 if int8_rings else model.dtype

    @property
    def device(self) -> torch.device:
        return self.model.device

    def quantize(self, *args, **kwargs) -> "GroundingEngine":
        raise _not_ported("quantize() (the int8 backbone and trunk)",
                          "ROADMAP queue A, item 9")

    @torch.no_grad()
    def init_state(self, word_ids) -> StreamState:
        """word_ids: (N, L), each stream's referring phrase. The language
        encoder runs once here and its features are cached in the state.
        The rings start as zeros in the ring dtype, the slot at
        n_frame - 1, so the first step writes slot 0."""
        cfg, n, dev = self.cfg, self.n_streams, self.device
        word_ids = torch.as_tensor(word_ids, device=dev)
        rings = tuple(
            torch.zeros((n, self.n_frame, g, g, cfg.emb_size),
                        dtype=self.ring_dtype, device=dev)
            for g in cfg.grids)
        w, k = self.fuse_window, self.topk
        return StreamState(
            feat_rings=rings,
            cache_boxes=torch.zeros((n, w, k, 4), device=dev),
            cache_scores=torch.zeros((n, w, k), device=dev),
            cache_feats=torch.zeros((n, w, k, cfg.emb_size),
                                    dtype=self.state_dtype, device=dev),
            frames_seen=torch.zeros((n,), dtype=torch.int32, device=dev),
            word_ids=word_ids,
            language=tuple(self.model.encode_language(word_ids)),
            slot=self.n_frame - 1)

    @torch.no_grad()
    def update_queries(self, state: StreamState, word_ids,
                       mask=None) -> StreamState:
        """Swap the referring phrases of some or all streams mid-flight.
        word_ids: (N, L); mask: (N,) host bool array, True where the
        stream's phrase changed (None = all). The encoder runs only on the
        changed streams, and their top-k caches and frame counts go to zero
        (their history grounded another phrase). Returns a new state; the
        input state is left as it was."""
        changed = (np.arange(self.n_streams) if mask is None
                   else np.nonzero(np.asarray(mask))[0])
        if changed.size == 0:
            return state
        dev = self.device
        idx = torch.as_tensor(changed, device=dev)
        changed_ids = torch.as_tensor(word_ids, device=dev)[idx]
        lang_new = self.model.encode_language(changed_ids)
        keep = torch.ones((self.n_streams,), device=dev).index_fill(0, idx, 0.0)
        # cast the mask, not the cache: the cache keeps its dtype
        keep_f = keep.to(state.cache_feats.dtype)
        return state._replace(
            word_ids=state.word_ids.index_copy(
                0, idx, changed_ids.to(state.word_ids.dtype)),
            language=tuple(full.index_copy(0, idx, part.to(full.dtype))
                           for full, part in zip(state.language, lang_new)),
            cache_boxes=state.cache_boxes * keep[:, None, None, None],
            cache_scores=state.cache_scores * keep[:, None, None],
            cache_feats=state.cache_feats * keep_f[:, None, None, None],
            frames_seen=state.frames_seen * keep.to(state.frames_seen.dtype))

    @torch.no_grad()
    def step(self, state: StreamState, frames
             ) -> Tuple[StreamState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Feed one new frame per stream: frames (N, H, W, 3). Returns
        (state, fused_boxes (N, 4), raw_boxes (N, 4), scores (N,)).
        Predictions are valid once frames_seen >= n_frame. With
        `donate_state` (the default) the step writes the new frame into the
        input state's rings: always continue from the returned state."""
        model, cfg = self.model, self.cfg
        frames = torch.as_tensor(frames, device=self.device)

        # 1. the backbone, only on the new frames
        new_feats = model.extract_features(frames)
        if self.int8_rings:
            new_feats = [torch.clamp(torch.round(f.float() * 127.0), -127, 127
                                     ).to(torch.int8) for f in new_feats]
        # 2. ring update: rotate mode writes one slot in place; shift mode
        #    rebuilds the whole ring (the A/B baseline)
        if self.rotate_rings:
            new_slot = (state.slot + 1) % self.n_frame
            rings = (state.feat_rings if self.donate_state
                     else tuple(r.clone() for r in state.feat_rings))
            for ring, f in zip(rings, new_feats):
                ring[:, new_slot] = f
        else:
            new_slot = state.slot
            rings = tuple(torch.cat([r[:, 1:], f[:, None].to(r.dtype)], dim=1)
                          for r, f in zip(state.feat_rings, new_feats))

        # 3. center-frame grounding off the rings and the cached phrase
        out = model.eval_features(
            rings, state.word_ids, language=state.language,
            newest_slot=new_slot if self.rotate_rings else None)
        dec = decode_best(out.outbox, cfg)
        raw_box, raw_score = dec.boxes[:, 0], dec.score[:, 0]

        # 4. per-stream top-k cache: drop the oldest entry, append this tick
        now = build_frame_cache(out.outbox, out.corr_feat, self.topk, cfg)
        cache_boxes = torch.cat([state.cache_boxes[:, 1:], now.boxes[:, None]], 1)
        cache_scores = torch.cat([state.cache_scores[:, 1:],
                                  now.scores[:, None]], 1)
        cache_feats = torch.cat(
            [state.cache_feats[:, 1:],
             now.feats[:, None].to(state.cache_feats.dtype)], 1)
        frames_seen = state.frames_seen + 1

        fused_box = self._fuse(cache_boxes, cache_scores, cache_feats,
                               frames_seen)
        new_state = state._replace(
            feat_rings=rings, cache_boxes=cache_boxes,
            cache_scores=cache_scores, cache_feats=cache_feats,
            frames_seen=frames_seen, slot=new_slot)
        return new_state, fused_box, raw_box, raw_score

    def _fuse(self, boxes: torch.Tensor, scores: torch.Tensor,
              feats: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
        """The temporal fusion of every stream's cache window around its
        center entry c = fuse_window // 2 (the single-center form of
        `eval.temporal.temporal_fuse`), in fp32 math over the stored
        features. Entries not filled yet (age >= frames seen) get zero
        weight. Returns the fused (N, 4) boxes."""
        n, wnd, k = scores.shape
        c = wnd // 2
        f32 = feats.float()
        sim = torch.einsum("nic,nrjc->nirj", f32[:, c], f32)    # (N, K, R, K)
        sim_max = sim.max(dim=3).values                         # (N, K, R)
        best_j = torch.argmax(sim, dim=3)                       # (N, K, R)
        picked = torch.gather(scores[:, None].expand(n, k, wnd, k), 3,
                              best_j[..., None])[..., 0]        # (N, K, R)
        w = torch.softmax(sim_max, dim=2)
        slot_age = torch.arange(wnd - 1, -1, -1, device=seen.device)
        valid = (seen[:, None] > slot_age[None, :]).to(w.dtype)  # (N, R)
        fused = torch.sum(w * valid[:, None, :] * picked, dim=2)  # (N, K)
        best = torch.argmax(fused, dim=1)
        return boxes[torch.arange(n, device=boxes.device), c, best]


@torch.no_grad()
def cast_params_for_serving(model: torch.nn.Module,
                            dtype: torch.dtype = torch.bfloat16) -> torch.nn.Module:
    """Round every float parameter of `model` to `dtype` in place, as the
    JAX package casts its float params for serving; BatchNorm running
    statistics (buffers) stay fp32. The parameters keep their fp32 storage
    (the modules cast them to the compute dtype at use), so the numbers are
    those of the JAX cast. Returns the model."""
    for p in model.parameters():
        if p.dtype == torch.float32:
            p.copy_(p.to(dtype))
    return model


def _storable(x: torch.Tensor) -> np.ndarray:
    """As numpy; bfloat16 (which .npy cannot hold) as float32, lossless."""
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _dtype_name(x: torch.Tensor) -> np.str_:
    return np.str_(str(x.dtype).replace("torch.", ""))


def save_stream_state(path: str, state: StreamState) -> None:
    """Persist all stream rings and caches to one .npz, with the keys and
    dtype records of the JAX package's `save_stream_state`, so a state
    saved by either package resumes in the other."""
    flat = {}
    for name in ("feat_rings", "language"):
        for i, x in enumerate(getattr(state, name)):
            flat[f"{name}/{i}"] = _storable(x)
            flat[f"{name}_dtype/{i}"] = _dtype_name(x)
    for k in ("cache_boxes", "cache_scores", "cache_feats", "frames_seen",
              "word_ids"):
        flat[k] = _storable(getattr(state, k))
    flat["slot"] = np.asarray(state.slot, np.int32)
    flat["cache_feats_dtype"] = _dtype_name(state.cache_feats)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_stream_state(path: str, device: DeviceLike = None) -> StreamState:
    """A state written by either package's `save_stream_state`, on `device`
    (the card by default). A file without a slot (the shift layout's)
    resumes with the newest frame in the last slot."""
    dev = resolve_device(device)
    data = np.load(path)

    def restore(key: str) -> torch.Tensor:
        dkey = key.replace("/", "_dtype/", 1) if "/" in key else key + "_dtype"
        x = torch.from_numpy(np.array(data[key])).to(dev)
        if dkey in data.files:
            x = x.to(getattr(torch, str(data[dkey])))
        return x

    def seq(prefix: str) -> Tuple[torch.Tensor, ...]:
        keys = sorted((k for k in data.files if k.startswith(prefix + "/")),
                      key=lambda k: int(k.split("/")[1]))
        return tuple(restore(k) for k in keys)

    rings = seq("feat_rings")
    slot: Optional[int] = int(data["slot"]) if "slot" in data.files else None
    return StreamState(
        feat_rings=rings,
        cache_boxes=restore("cache_boxes"),
        cache_scores=restore("cache_scores"),
        cache_feats=restore("cache_feats"),
        frames_seen=restore("frames_seen"),
        word_ids=restore("word_ids"),
        language=seq("language"),
        slot=rings[0].shape[1] - 1 if slot is None else slot)
