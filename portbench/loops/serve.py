"""Served ticks: `GroundingEngine.step` over N live streams, a closed loop.

Each tick hands the engine one new letterboxed frame per stream, copied
from a pinned host pool of `pool_ticks` ticks of video (each stream a view
moving over its own scene, `inputs.video`), and reads every stream's
fused box, raw box and score back to the host before the next tick. Every stream grounds one phrase, set at `init_state`. The
first `warmup_ticks` ticks fill the rings and the top-k caches and count
as set-up. With `quantize` the engine runs `quantize()` on calibration
frames drawn from the seed, as part of set-up.
"""

from __future__ import annotations

import time

import torch

from portbench import inputs
from portbench import compare as C
from portbench.reference import model as M
from portbench.reference import tasks


class Runner:
    def __init__(self, ctx):
        from dcnet_tpu_torch.serving.engine import GroundingEngine, cast_params_for_serving

        from portbench.program import build_model

        self.ctx = ctx
        g, t, dev = ctx.geometry, ctx.traffic, ctx.device
        self.n = t["streams"]
        self.items = self.n
        model = build_model(g, t, ctx.weights(), dev)
        cast_params_for_serving(model, model.dtype)
        eng = GroundingEngine(model, self.n, n_frame=g.n_frames_test, topk=t["topk"],
                              fuse_window=t["fuse_window"], int8_rings=t.get("int8_rings", False))
        gen = inputs.generator(ctx.seed, "phrases", dev)
        self.ids = inputs.corpus_phrases(gen, self.n, g.query_len, g.corpus_size,
                                         t["min_words"], t["max_words"], dev)
        gen = inputs.generator(ctx.seed, "frames", dev)
        size = g.image_size
        pool = inputs.video(gen, self.n, t["pool_ticks"], size, dev)
        if t.get("quantize"):
            calib = inputs.frames(inputs.generator(ctx.seed, "calibration", dev),
                                  t["calibration_frames"], size, dev)
            eng.quantize(calib, self.ids[:1])
        self.pool = torch.empty(pool.shape, dtype=pool.dtype, pin_memory=dev.type == "cuda")
        self.pool.copy_(pool)
        del pool
        self.engine, self.model = eng, model
        self.state = eng.init_state(self.ids)
        self.tick = 0
        self.answers = []          # per tick: (N, 9) fused box, raw box, score

    def run_unit(self) -> float:
        fr = self.pool[self.tick % self.pool.shape[0]].to(self.ctx.device, non_blocking=True)
        h0 = time.perf_counter()
        self.state, fused, raw, score = self.engine.step(self.state, fr)
        h1 = time.perf_counter()
        self.answers.append(torch.cat([fused.float(), raw.float(), score.float()[:, None]],
                                      1).cpu())
        self.tick += 1
        return h1 - h0

    @property
    def done(self) -> int:
        """Units run so far."""
        return self.tick

    def warmup(self) -> None:
        for _ in range(self.ctx.traffic["warmup_ticks"]):
            self.run_unit()

    def release(self) -> None:
        self.state = self.engine = self.model = None

    # --- correctness ---------------------------------------------------------

    def _samples(self, first: int, last: int):
        """(stream, tick) pairs: every stream at `check_ticks` ticks drawn
        from the seed among the ticks first..last - 1 (the window's), so
        that every slot of the batch is judged."""
        k = self.ctx.traffic["check_ticks"]
        gen = torch.Generator().manual_seed(inputs.sub_seed(self.ctx.seed, "check"))
        streams = torch.arange(self.n).repeat(k)
        ticks = first + torch.randint(0, last - first, (k * self.n,), generator=gen)
        return streams, ticks

    def _reference(self, W, streams, ticks, prec: M.Prec):
        """The reference's tick for each sample, `check_block` samples at a
        time, the tables of all concatenated."""
        g, dev = self.ctx.geometry, self.ctx.device
        hist = 2 * g.n_frames_test - 1
        pool_ticks = self.pool.shape[0]
        block = self.ctx.traffic["check_block"]
        parts = []
        for i in range(0, len(streams), block):
            ss, tt = streams[i:i + block], ticks[i:i + block]
            frames = torch.stack([
                torch.stack([self.pool[(int(t) - hist + 1 + j) % pool_ticks, int(s)]
                             for j in range(hist)]) for s, t in zip(ss, tt)]).to(dev)
            parts.append(tasks.serve(W, g, frames, self.ids[ss.to(dev)], (tt + 1).to(dev),
                                     self.ctx.traffic["topk"], prec))
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def check(self, first: int, last: int, control: str = "") -> dict:
        """The numbers `correct` compares: the program's answers (or, with
        `control`, the reference's at that precision) against the reference."""
        streams, ticks = self._samples(first, last)
        W = self.ctx.weights()
        ref = self._reference(W, streams, ticks, M.FP32)
        if control:
            got = self._reference(W, streams, ticks, M.Prec(control))
            fused, raw, score = got["fused_box"], got["raw_box"], got["raw_score"]
        else:
            ans = torch.stack([self.answers[int(t)][int(s)] for s, t in zip(streams, ticks)])
            ans = ans.to(self.ctx.device)
            fused, raw, score = ans[:, :4], ans[:, 4:8], ans[:, 8]
        return C.detection(
            C.raw_gaps(raw, score, ref["cand_boxes"], ref["cand_conf"]),
            C.fused_gaps(fused, ref["ctr_boxes"], ref["ctr_conf"], ref["fused_all"],
                         ref["fused_best"], ref["conf_kth"]))
