"""The serving bundle: the engine's tick and its language encoder as saved
`torch.export` programs, served without the model code. The port of
`dcnet_tpu/serving/export.py`.

`export_engine` traces the engine's `step` (rotating rings, the slot a
dynamic integer input, the rings written in place as the engine writes
them with `donate_state`) and `encode_language` (the BiLSTM or the BERT
encoder) with `torch.export`, and writes them with `torch.export.save`
beside a `meta.json` that has the JAX bundle's keys. The hand-written
kernels are registered operators (`dcnet::attend`, `dcnet::ring`,
`dcnet::conv_s8`, `dcnet::conv_s8_quant`; `dcnet_tpu_torch.kernels`), so
the programs call them: a loaded tick launches K1 or K4, and after
`quantize()` K6, as the live engine does, and counts them in
`kernels.LAUNCHES`. After `quantize()` the int8 backbone and the trunk's
int8 constants are constants of the program.

`ServingRuntime` loads a bundle and serves it with the engine's
`init_state` / `encode_language` / `step` contract. It imports the
operator library and `serving.state`, and no model module.

    engine = GroundingEngine(model, n_streams=120)
    engine.quantize(calib_frames)                 # optional int8 path
    export_engine(engine, "artifacts/engine")     # step.pt2, encode_lang.pt2, meta.json
    ...
    rt = ServingRuntime("artifacts/engine")       # on the card
    state = rt.init_state(word_ids)
    state, fused, raw, score = rt.step(state, frames)

The weights travel in the programs. `state_dict` (the reference key
namespace, `weights.state_dict_from_jax`) replaces them at load. A bundle
runs on the device kind it was exported on (`meta["platforms"]`); loading
it for another raises.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn

import dcnet_tpu_torch.kernels  # noqa: F401  (registers the dcnet:: operators)
from dcnet_tpu_torch import DeviceLike, resolve_device
from dcnet_tpu_torch.serving.state import StreamState

_META = "meta.json"
_STEP = "step.pt2"
_LANG = "encode_lang.pt2"
_PREFIX = "model."  # the programs' parameters sit under the model's names


class _Tick(nn.Module):
    """The engine's step over flat arguments, for `torch.export`: the
    rings are written in place, the slot is the state's (an integer)."""

    def __init__(self, engine):
        super().__init__()
        self.model = engine.model
        self.engine = engine

    def forward(self, rings, cache_boxes, cache_scores, cache_feats, frames_seen,
                word_ids, language, frames, slot: int):
        state = StreamState(tuple(rings), cache_boxes, cache_scores, cache_feats,
                            frames_seen, word_ids, tuple(language), slot)
        new, fused, raw, score = self.engine.step(state, frames)
        return (new.cache_boxes, new.cache_scores, new.cache_feats, new.frames_seen,
                fused, raw, score)


class _Language(nn.Module):
    """`encode_language` over the modules it reads (the text encoder and
    `mapping_lang`, under the model's names): the program carries their
    weights and no others."""

    def __init__(self, model):
        super().__init__()
        self.model = nn.Module()
        self.model.textmodel, self.model.mapping_lang = model.textmodel, model.mapping_lang
        self.encode = model.encode_language

    def forward(self, word_ids):
        return tuple(self.encode(word_ids))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def export_engine(engine, out_dir: str, warmup_frames: Optional[torch.Tensor] = None
                  ) -> Dict:
    """Write the serving bundle of `engine` (a `GroundingEngine` with
    rotating rings) to `out_dir`: `step.pt2`, `encode_lang.pt2` and
    `meta.json`. One warm-up tick on `warmup_frames` (zeros by default) of
    a throwaway state runs first, so the int8 trunk's constants exist
    before the trace reads them. Returns the meta."""
    if not engine.rotate_rings:
        raise ValueError("the bundle serves rotating rings (rotate_rings=True)")
    if engine.mesh is not None:
        raise ValueError("the bundle serves one process's engine: export an engine "
                         "without a mesh")
    cfg, n, dev = engine.cfg, engine.n_streams, engine.device
    model = engine.model
    os.makedirs(out_dir, exist_ok=True)
    ids = torch.ones((n, cfg.query_len), dtype=torch.long, device=dev)
    frames = (torch.zeros((n, cfg.image_size, cfg.image_size, 3), device=dev)
              if warmup_frames is None else torch.as_tensor(warmup_frames, device=dev))
    donate = engine.donate_state
    engine.donate_state = True  # the program writes the rings in place
    try:
        with torch.no_grad():
            state = engine.init_state(ids)
            engine.step(state, frames)                 # fills the int8 constants
            state = engine.init_state(ids)
            lang = torch.export.export(_Language(model).eval(), (ids,), strict=False)
            args = (list(state.feat_rings), state.cache_boxes, state.cache_scores,
                    state.cache_feats, state.frames_seen, state.word_ids,
                    list(state.language), frames, state.slot)
            # every shape static; the slot an integer input of any value
            dyn = ([None] * len(args[0]), None, None, None, None, None,
                   [None] * len(args[6]), None, torch.export.Dim.DYNAMIC)
            step = torch.export.export(_Tick(engine).eval(), args, dynamic_shapes=dyn,
                                       strict=False)
    finally:
        engine.donate_state = donate
    for prog in (step, lang):  # the bundle carries no example state (rings, frames)
        prog.example_inputs = None
    torch.export.save(step, os.path.join(out_dir, _STEP))
    torch.export.save(lang, os.path.join(out_dir, _LANG))
    meta = {
        "n_streams": n, "n_frame": engine.n_frame, "topk": engine.topk,
        "fuse_window": engine.fuse_window, "grids": list(cfg.grids),
        "emb_size": cfg.emb_size, "query_len": cfg.query_len,
        "image_size": cfg.image_size, "quantized": engine.qparams is not None,
        "state_dtype": _dtype_name(engine.state_dtype),
        "ring_dtype": _dtype_name(engine.ring_dtype),
        "multiref": bool(cfg.coattn_multiref),
        "platforms": [dev.type],
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


class ServingRuntime:
    """Serve an exported bundle without the model code, on `device` (the
    card by default), with `GroundingEngine`'s `init_state` /
    `encode_language` / `step` contract. `state_dict` (reference key
    namespace) replaces the weights the programs carry; keys the programs
    do not read (weights folded into int8 constants, the other program's)
    are ignored, and a program weight it lacks raises. `step` writes the
    new frame into the input state's rings, as the engine does with
    `donate_state`: always continue from the returned state."""

    def __init__(self, bundle_dir: str, state_dict: Optional[Dict] = None,
                 device: DeviceLike = None):
        with open(os.path.join(bundle_dir, _META)) as f:
            self.meta = json.load(f)
        self.device = resolve_device(device)
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(f"bundle {bundle_dir} was exported for "
                             f"{self.meta['platforms']}, not {self.device.type}: "
                             f"export it again on this device kind")
        self._step = torch.export.load(os.path.join(bundle_dir, _STEP)).module()
        self._lang = torch.export.load(os.path.join(bundle_dir, _LANG)).module()
        if state_dict is not None:
            for prog in (self._step, self._lang):
                _replace_weights(prog, state_dict)

    def encode_language(self, word_ids) -> Tuple[torch.Tensor, ...]:
        ids = torch.as_tensor(word_ids, device=self.device).long()
        with torch.no_grad():
            return tuple(self._lang(ids))

    def init_state(self, word_ids) -> StreamState:
        m, dev = self.meta, self.device
        n, w, k = m["n_streams"], m["fuse_window"], m["topk"]
        ids = torch.as_tensor(word_ids, device=dev).long()
        ring_dt = getattr(torch, m["ring_dtype"])
        st = getattr(torch, m["state_dtype"])
        return StreamState(
            feat_rings=tuple(torch.zeros((n, m["n_frame"], g, g, m["emb_size"]),
                                         dtype=ring_dt, device=dev) for g in m["grids"]),
            cache_boxes=torch.zeros((n, w, k, 4), device=dev),
            cache_scores=torch.zeros((n, w, k), device=dev),
            cache_feats=torch.zeros((n, w, k, m["emb_size"]), dtype=st, device=dev),
            frames_seen=torch.zeros((n,), dtype=torch.int32, device=dev),
            word_ids=ids,
            language=self.encode_language(ids),
            slot=m["n_frame"] - 1)

    def step(self, state: StreamState, frames
             ) -> Tuple[StreamState, torch.Tensor, torch.Tensor, torch.Tensor]:
        frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            boxes, scores, feats, seen, fused, raw, score = self._step(
                list(state.feat_rings), state.cache_boxes, state.cache_scores,
                state.cache_feats, state.frames_seen, state.word_ids,
                list(state.language), frames, int(state.slot))
        new = state._replace(cache_boxes=boxes, cache_scores=scores, cache_feats=feats,
                             frames_seen=seen,
                             slot=(int(state.slot) + 1) % self.meta["n_frame"])
        return new, fused, raw, score


def _replace_weights(prog: nn.Module, state_dict: Dict) -> None:
    """Load the reference-namespace `state_dict` into a loaded program's
    parameters and buffers (named `model.<key>`)."""
    own = prog.state_dict()
    missing = [k for k in own if k.startswith(_PREFIX)
               and k[len(_PREFIX):] not in state_dict]
    if missing:
        raise KeyError(f"state_dict lacks {len(missing)} weights the program reads, "
                       f"e.g. {missing[:3]}")
    with torch.no_grad():
        for k, t in own.items():
            if k.startswith(_PREFIX):
                t.copy_(torch.as_tensor(state_dict[k[len(_PREFIX):]]).to(t.dtype))
