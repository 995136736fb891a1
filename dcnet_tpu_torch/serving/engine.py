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
so a tick reads no device scalar. In place of `jax.jit`'s one dispatch, a
tick on a card replays a CUDA graph where the engine can observe that one
is sound (`_graphable`: a CUDA model, no mesh, rotating rings, donated
state, no `torch.export` trace): one graph per ring slot, captured on the
slot's second tick over state buffers the engine owns (`_TickGraphs`), so
the card and not the host's dispatch sets the tick. Its outputs and state
are bitwise those of the eager tick (`_tick`), which every other engine
runs. `quantize()` switches the per-frame
backbone to the int8 path (`ops/quant.py`, kernel K6; `int8_chain` keeps
sole-consumer activations in int8) and, by default, the trunk convs to
static-scale int8. XLA compiler options are not carried.
`serving/export.py` exports the step as a `torch.export` program that
serves without this module.

The engine's mesh (`mesh=parallel.mesh.make_mesh(...)`): the streams are
sharded over the mesh's `data` axis, as the JAX engine places them with
`batch_sharding(mesh)`. Each of the W data ranks owns streams
[r N / W, (r + 1) N / W) (N % W != 0 raises, as a JAX `data` sharding
does) and keeps their rings and caches; `init_state`, `update_queries` and
`step` take the global arrays and `step` returns the global outputs on
every rank (all-gathered over the data group). The ranks of one model
group hold the same streams (and split their co-attention rows under
`cfg.tp_internals`). `save_stream_state(..., mesh=)` writes one global
file from the shards (rank 0 writes what the data group gathered) and
`load_stream_state(..., mesh=)` gives each rank its streams of one, so a
state moves between a one-process and an N-process engine both ways.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dcnet_tpu_torch import DeviceLike, kernels, not_ported, resolve_device
from dcnet_tpu_torch.eval.temporal import build_frame_cache
from dcnet_tpu_torch.models.dcnet import DCNet
from dcnet_tpu_torch.ops.decode import decode_best
from dcnet_tpu_torch.parallel import mesh as pmesh
from dcnet_tpu_torch.serving.state import StreamState
from dcnet_tpu_torch.utils.profiling import COUNTERS, on_device, trace_annotation

__all__ = ["GroundingEngine", "StreamState", "cast_params_for_serving",
           "load_stream_state", "save_stream_state"]


class GroundingEngine:
    """Batched streaming server over a `DCNet`; runs on the model's device
    and stores its rings and caches in the model's compute dtype."""

    def __init__(self, model: DCNet, n_streams: int, n_frame: int = 5,
                 topk: int = 5, fuse_window: int = 5, mesh=None,
                 donate_state: bool = True, rotate_rings: bool = True,
                 int8_rings: bool = False, int8_chain: bool = False,
                 compiler_options=None):
        if compiler_options:
            raise not_ported("compiler_options (XLA/TPU compiler flags)",
                             "XLA options have no PyTorch counterpart")
        self.model = model
        self.cfg = model.cfg
        self.mesh = mesh
        self.n_streams = n_streams   # every rank's streams: the global arrays
        self.shard = _stream_shard(n_streams, mesh)
        self.n_frame = n_frame
        self.topk = topk
        self.fuse_window = fuse_window
        self.donate_state = donate_state
        self.rotate_rings = rotate_rings
        self.int8_rings = int8_rings
        # int8_chain: sole-consumer backbone activations stay int8 between
        # convs (requantized in K6's epilogue); it acts after quantize()
        self.int8_chain = int8_chain
        self.state_dtype = model.dtype
        self.ring_dtype = torch.int8 if int8_rings else model.dtype
        self.qparams = None       # the int8 backbone, after quantize()
        self.trunk_scales = None  # the trunk convs' calibrated abs-max
        self._graphs: Optional[_TickGraphs] = None  # the replayed ticks' buffers and graphs
        self._trunk_srcs: Optional[Tuple[torch.Tensor, ...]] = None  # `_trunk_version`'s

    @property
    def device(self) -> torch.device:
        return self.model.device

    @torch.no_grad()
    def quantize(self, calib_frames, calib_word_ids=None,
                 trunk: bool = True) -> "GroundingEngine":
        """Switch the per-frame backbone to the int8 path: activation
        scales calibrated on `calib_frames` (M, H, W, 3), representative
        stream frames. With `trunk` the trunk convs (mapping_visu,
        corr_conv, fcn) also run static-scale int8, calibrated in one
        `map_features` + `eval_features` pass over the int8 backbone's raw
        outputs of the first n_frame frames (the features the served step
        sees) with `calib_word_ids[:1]` (ones by default). The model's
        trunk mode is switched in place. Call after
        `cast_params_for_serving`. Returns the engine."""
        from dcnet_tpu_torch.ops import quant as Q
        self._graphs = None   # the graphs hold the float tick
        model = self.model
        frames = torch.as_tensor(calib_frames, device=self.device)
        self.qparams = Q.quantize_model_backbone(model, frames)
        if trunk:
            n_frame = self.n_frame
            if frames.shape[0] < n_frame:
                raise ValueError(f"trunk calibration needs >= n_frame={n_frame} "
                                 f"frames, got {frames.shape[0]}")
            if calib_word_ids is None:
                calib_word_ids = torch.ones((1, self.cfg.query_len), dtype=torch.long)
            wid = torch.as_tensor(calib_word_ids, device=self.device)[:1]
            raw = Q.backbone_apply_int8(Q.model_layer_defs(model), self.qparams,
                                        frames[:n_frame], act_dtype=model.dtype)

            def calib_path(mdl):
                feats = mdl.map_features(raw)
                per_frame = [f.reshape(1, n_frame, *f.shape[1:]) for f in feats]
                return mdl.eval_features(per_frame, wid)

            self.trunk_scales = Q.calibrate_trunk(model, calib_path)
            Q.trunk_quant_variant(model, "int8")
        return self

    def _extract(self, frames: torch.Tensor):
        if self.qparams is not None:
            from dcnet_tpu_torch.ops import quant as Q
            return Q.quant_extract_features(self.model, self.qparams, frames,
                                            int8_chain=self.int8_chain)
        return self.model.extract_features(frames)

    @torch.no_grad()
    def init_state(self, word_ids) -> StreamState:
        """word_ids: (N, L), each stream's referring phrase. The language
        encoder runs once here and its features are cached in the state.
        The rings start as zeros in the ring dtype, the slot at
        n_frame - 1, so the first step writes slot 0."""
        cfg, dev = self.cfg, self.device
        word_ids = torch.as_tensor(word_ids, device=dev)[self.shard]
        n = word_ids.shape[0]
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
        input state is left as it was. On a mesh each rank takes its
        streams' rows of both."""
        n = self.shard.stop - self.shard.start
        changed = (np.arange(n) if mask is None
                   else np.nonzero(np.asarray(mask)[self.shard])[0])
        if changed.size == 0:
            return state
        dev = self.device
        idx = torch.as_tensor(changed, device=dev)
        changed_ids = torch.as_tensor(word_ids, device=dev)[self.shard][idx]
        lang_new = self.model.encode_language(changed_ids)
        keep = torch.ones((n,), device=dev).index_fill(0, idx, 0.0)
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

    @trace_annotation("engine.step")
    @torch.no_grad()
    def step(self, state: StreamState, frames
             ) -> Tuple[StreamState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Feed one new frame per stream: frames (N, H, W, 3). Returns
        (state, fused_boxes (N, 4), raw_boxes (N, 4), scores (N,)).
        Predictions are valid once frames_seen >= n_frame. With
        `donate_state` (the default) the step writes the new frame into the
        input state's rings, and on a card every tensor of the input state
        may be overwritten: always continue from the returned state. On a
        mesh, frames are every stream's and the outputs too (this rank's
        streams ticked, the rest all-gathered); the state is this rank's.

        Where `_graphable` holds, the tick replays its ring slot's CUDA
        graph (the spans `engine.copy_in`, `engine.replay`; the model's
        stage spans only on a slot's first, eager tick and on its capture);
        elsewhere it runs `_tick`. The graphs are captured anew where the
        frames, the state's shapes, `qparams`, `int8_chain`, the model's
        trunk mode or, in int8 mode, what the trunk's constants are made
        from (`set_trunk_scales`, a weight load) change."""
        if not self._graphable():
            return self._tick(state, frames)
        return self._replayed_tick(state, on_device(frames, self.device))

    def _graphable(self) -> bool:
        """Whether a tick may replay a CUDA graph: a CUDA model, no mesh
        (its all-gathers and row windows stay eager), rotating rings (the
        shift baseline rebuilds the rings), donated state (the graph writes
        in place), and neither a `torch.export` / compile trace nor a
        capture of the caller's running."""
        return (self.device.type == "cuda" and self.mesh is None and self.rotate_rings
                and self.donate_state and not torch.compiler.is_compiling()
                and not torch.cuda.is_current_stream_capturing())

    def _replayed_tick(self, state: StreamState, frames: torch.Tensor
                       ) -> Tuple[StreamState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """The tick through the graph of its ring slot. The state and the
        frames are copied into the engine's buffers where they are not
        those already; a slot's first tick runs `_tick` eagerly on them (a
        warm-up: cuDNN plans, cached tables, kernel plans and library loads
        happen outside any capture), its second captures its graph, and
        every tick from then on replays it. The outputs are cloned out of
        the graphs' memory; the returned state holds the buffers."""
        graphs = self._graphs
        sig = _signature(self, state, frames)
        if graphs is None or graphs.sig != sig:
            graphs = self._graphs = _TickGraphs(sig, state, frames, self.qparams)
        with trace_annotation("engine.copy_in"):
            graphs.copy_in(state, frames)
        slot = (state.slot + 1) % self.n_frame
        entry = graphs.slots.get(slot)
        if entry is None:
            outs = graphs.warm_up(self._tick, state.slot)
            graphs.slots[slot] = ()
            return (graphs.state(slot), *(o.clone() for o in outs))
        if not entry:
            entry = graphs.slots[slot] = graphs.capture(self._tick, state.slot)
            COUNTERS["graph_captures"] += 1
        graph, outs, launches = entry
        with trace_annotation("engine.replay"):
            graph.replay()
            for k, v in launches.items():
                kernels.LAUNCHES[k] += v
            COUNTERS["graph_replays"] += 1
            return (graphs.state(slot), *(o.clone() for o in outs))

    @torch.no_grad()
    def _tick(self, state: StreamState, frames
              ) -> Tuple[StreamState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """One tick, eagerly: `step`'s contract. `serving/export.py` traces
        it."""
        model, cfg = self.model, self.cfg
        frames = on_device(frames, self.device)[self.shard]

        # 1. the backbone, only on the new frames (int8 after quantize())
        new_feats = self._extract(frames)
        # 2. ring update: rotate mode writes one slot in place; shift mode
        #    rebuilds the whole ring (the A/B baseline)
        with trace_annotation("engine.ring"):
            if self.int8_rings:
                new_feats = [torch.clamp(torch.round(f.float() * 127.0), -127, 127
                                         ).to(torch.int8) for f in new_feats]
            if self.rotate_rings:
                new_slot = (state.slot + 1) % self.n_frame
                rings = (state.feat_rings if self.donate_state
                         else tuple(r.clone() for r in state.feat_rings))
                for ring, f in zip(rings, new_feats):
                    # narrow + copy_ keeps a symbolic slot symbolic under
                    # torch.export (an indexed store would specialise on it)
                    ring.narrow(1, new_slot, 1).copy_(f[:, None])
            else:
                new_slot = state.slot
                rings = tuple(torch.cat([r[:, 1:], f[:, None].to(r.dtype)], dim=1)
                              for r, f in zip(state.feat_rings, new_feats))

        # 3. center-frame grounding off the rings and the cached phrase
        out = model.eval_features(
            rings, state.word_ids, language=state.language,
            newest_slot=new_slot if self.rotate_rings else None)
        with trace_annotation("engine.decode"):
            dec = decode_best(out.outbox, cfg)
            raw_box, raw_score = dec.boxes[:, 0], dec.score[:, 0]

        # 4. per-stream top-k cache: drop the oldest entry, append this tick
        with trace_annotation("engine.cache"):
            now = build_frame_cache(out.outbox, out.corr_feat, self.topk, cfg)
            cache_boxes = torch.cat([state.cache_boxes[:, 1:], now.boxes[:, None]], 1)
            cache_scores = torch.cat([state.cache_scores[:, 1:],
                                      now.scores[:, None]], 1)
            cache_feats = torch.cat(
                [state.cache_feats[:, 1:],
                 now.feats[:, None].to(state.cache_feats.dtype)], 1)
            frames_seen = state.frames_seen + 1

        with trace_annotation("engine.fuse"):
            fused_box = self._fuse(cache_boxes, cache_scores, cache_feats,
                                   frames_seen)
            new_state = state._replace(
                feat_rings=rings, cache_boxes=cache_boxes,
                cache_scores=cache_scores, cache_feats=cache_feats,
                frames_seen=frames_seen, slot=new_slot)
            return (new_state, _gather_streams(fused_box, self.mesh),
                    _gather_streams(raw_box, self.mesh),
                    _gather_streams(raw_score, self.mesh))

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


_STATE_FIELDS = ("cache_boxes", "cache_scores", "cache_feats", "frames_seen", "word_ids")


def _state_tensors(state: StreamState) -> Tuple[torch.Tensor, ...]:
    """Every tensor of a state, rings first, the language last."""
    return (*state.feat_rings, *(getattr(state, k) for k in _STATE_FIELDS),
            *state.language)


def _signature(engine: GroundingEngine, state: StreamState, frames: torch.Tensor) -> tuple:
    """What a tick's graphs are captured for: the shape, dtype and device
    of the frames and of every state tensor (N among them), and what the
    tick runs besides: the engine's int8 backbone (by identity; the graphs
    keep it alive, so its id is not reused), its int8 chain, the model's
    trunk mode (which another engine's `quantize()` may switch on a shared
    model) and `_trunk_version`."""
    return (id(engine.qparams), engine.int8_chain, engine.model.cfg.trunk_quant,
            _trunk_version(engine), len(state.feat_rings), len(state.language)) + tuple(
        (tuple(t.shape), t.dtype, t.device) for t in (*_state_tensors(state), frames))


def _trunk_version(engine: GroundingEngine) -> int:
    """In int8 trunk mode, the summed version counters of what the trunk's
    cached constants are made from (0 otherwise): an in-place change, such
    as `set_trunk_scales` or a weight load, makes the eager tick remake
    them, while a graph would replay the ones its capture read. Inference
    tensors keep no counter; the trunk then remakes its constants on every
    call, inside the graph too."""
    if engine.model.cfg.trunk_quant != "int8":
        return 0
    if engine._trunk_srcs is None:
        from dcnet_tpu_torch.ops import quant as Q
        engine._trunk_srcs = tuple(t for t in Q.trunk_sources(engine.model)
                                   if not t.is_inference())
    return sum(t._version for t in engine._trunk_srcs)


class _TickGraphs:
    """The replayed ticks of one signature (`_signature`; `qparams` is the
    int8 backbone it names, kept alive): the frames buffer and one buffer
    for each state tensor, allocated outside any graph's pool (their
    addresses never move), a side stream to warm up and capture on (CUDA
    graphs are not captured on the default stream), and per ring slot
    (`slots`, keyed by the slot the tick writes) `()` once its eager tick
    ran, then its graph, the graph's outputs and the kernel launches its
    capture counted. The graphs share one memory pool: a replay's outputs
    are cloned before the next replay."""

    def __init__(self, sig: tuple, state: StreamState, frames: torch.Tensor, qparams):
        self.sig, self.qparams = sig, qparams
        self.n_rings = len(state.feat_rings)
        self.frames = torch.empty_like(frames, memory_format=torch.contiguous_format)
        self.bufs = tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                          for t in _state_tensors(state))
        self.side = torch.cuda.Stream(frames.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.slots: dict = {}

    def copy_in(self, state: StreamState, frames: torch.Tensor) -> None:
        """The frames, and each state tensor that is not its buffer, into
        the buffers (device copies on the current stream)."""
        self.frames.copy_(frames)
        self.store(state)

    def store(self, state: StreamState) -> None:
        """Each tensor of `state` that is not its buffer, into the buffer."""
        for buf, t in zip(self.bufs, _state_tensors(state)):
            if t is not buf:
                buf.copy_(t)

    def state(self, slot: int) -> StreamState:
        """The state the buffers hold, its newest frame in `slot`."""
        r = self.n_rings
        rest = dict(zip(_STATE_FIELDS, self.bufs[r:r + len(_STATE_FIELDS)]))
        return StreamState(feat_rings=self.bufs[:r], slot=slot,
                           language=self.bufs[r + len(_STATE_FIELDS):], **rest)

    def run(self, tick, slot: int) -> Tuple[torch.Tensor, ...]:
        """`tick` on the buffers (the state's newest frame in `slot`), its
        new state written back into them; returns its three outputs."""
        new, *outs = tick(self.state(slot), self.frames)
        self.store(new)
        return tuple(outs)

    def warm_up(self, tick, slot: int) -> Tuple[torch.Tensor, ...]:
        """`run(tick, slot)` eagerly on the side stream, where the capture
        will run (what a first call sets up per stream, such as cuBLAS's
        workspace, then exists before the capture), ordered after the
        current stream's work and before its later work."""
        cur = torch.cuda.current_stream(self.frames.device)
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side):
            outs = self.run(tick, slot)
        cur.wait_stream(self.side)
        return outs

    def capture(self, tick, slot: int):
        """The graph of `run(tick, slot)`, captured on the side stream into
        the shared pool: (graph, its outputs, the launches it holds). The
        capture's own count of launches is taken back: a replay adds it."""
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.side):
            outs = self.run(tick, slot)
        launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
        kernels.LAUNCHES.update(before)
        return graph, outs, launches


def _stream_shard(n_streams: int, mesh) -> slice:
    """This rank's streams: [r N / W, (r + 1) N / W) of the mesh's W data
    ranks (all of them without a mesh)."""
    w, r = (1, 0) if mesh is None else (mesh.n_data, mesh.data_rank)
    if n_streams % w:
        raise ValueError(f"{n_streams} streams do not shard over the mesh's {w} "
                         f"data ranks")
    per = n_streams // w
    return slice(r * per, (r + 1) * per)


def _gather_streams(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every data rank's rows of x (its streams), concatenated in rank
    order: the global array, on every rank."""
    if mesh is None or mesh.n_data == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.n_data)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts, dim=0)


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


def save_stream_state(path: str, state: StreamState, mesh=None) -> None:
    """Persist all stream rings and caches to one .npz, with the keys and
    dtype records of the JAX package's `save_stream_state`, so a state
    saved by either package resumes in the other. A mesh engine's state
    (`mesh`: every rank calls) is gathered over the data group and written
    once, by rank 0, as the global state."""
    if mesh is not None:
        state = state._replace(**{
            k: (tuple(_gather_streams(x, mesh) for x in v) if isinstance(v, tuple)
                else _gather_streams(v, mesh))
            for k, v in state._asdict().items() if k != "slot"})
        if pmesh.world()[1] != 0:
            pmesh.barrier()
            return
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
    if mesh is not None:
        pmesh.barrier()    # the file is whole before any rank reads it


def load_stream_state(path: str, device: DeviceLike = None, mesh=None) -> StreamState:
    """A state written by either package's `save_stream_state`, on `device`
    (the card by default). A file without a slot (the shift layout's)
    resumes with the newest frame in the last slot. With a mesh engine's
    `mesh`, this rank's streams of the global state."""
    dev = resolve_device(device)
    data = np.load(path)
    shard = _stream_shard(data["frames_seen"].shape[0], mesh)

    def restore(key: str) -> torch.Tensor:
        dkey = key.replace("/", "_dtype/", 1) if "/" in key else key + "_dtype"
        x = torch.from_numpy(np.array(data[key])[shard]).to(dev)
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
