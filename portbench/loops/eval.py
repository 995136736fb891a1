"""Offline evaluation calls: `DCNet.eval_clip` then `decode_best` on a batch
of clips, a closed loop.

Each call copies a batch of `clips` clips of `n_frames_test` frames from a
pinned host pool of `pool_batches` distinct batches (non-blocking), with
their phrases, and reads every clip's box, score and anchor index back to
the host. `warmup_calls` calls count as set-up.
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
        from portbench.program import build_model

        self.ctx = ctx
        g, t, dev = ctx.geometry, ctx.traffic, ctx.device
        self.clips, n = t["clips"], g.n_frames_test
        self.items = self.clips
        self.model = build_model(g, t, ctx.weights(), dev)
        batches = t["pool_batches"]
        gen = inputs.generator(ctx.seed, "phrases", dev)
        if g.text_encoder == "bert":
            ids = inputs.bert_phrases(gen, batches * self.clips, g.query_len, g.bert.vocab_size,
                                      t["min_words"], t["max_words"], dev)
        else:
            ids = inputs.corpus_phrases(gen, batches * self.clips, g.query_len, g.corpus_size,
                                        t["min_words"], t["max_words"], dev)
        self.ids = ids.reshape(batches, self.clips, g.query_len)
        pool = inputs.clips(inputs.generator(ctx.seed, "frames", dev), batches * self.clips, n,
                            g.image_size, dev)
        self.pool = torch.empty(pool.shape, dtype=pool.dtype, pin_memory=dev.type == "cuda")
        self.pool.copy_(pool)
        self.pool = self.pool.reshape(batches, self.clips * n, *pool.shape[1:])
        del pool
        cfg = self.model.cfg
        self.offsets = torch.tensor(cfg.scale_offsets(), device=dev)
        self.grids = torch.tensor(cfg.grids, device=dev)
        self.call = 0
        self.answers = []          # per call: (clips, 6) box, score, flat index

    def run_unit(self) -> float:
        from dcnet_tpu_torch.ops.decode import decode_best

        b = self.call % self.pool.shape[0]
        images = self.pool[b].to(self.ctx.device, non_blocking=True)
        h0 = time.perf_counter()
        out = self.model.eval_clip(images, self.ids[b], n_frame=self.ctx.geometry.n_frames_test)
        dec = decode_best(out.outbox, self.model.cfg)
        h1 = time.perf_counter()
        g = self.grids[dec.scale[:, 0].long()]
        idx = (self.offsets[dec.scale[:, 0].long()] + (dec.best_n[:, 0] % 3) * g * g
               + dec.gj[:, 0] * g + dec.gi[:, 0])
        self.answers.append(torch.cat([dec.boxes[:, 0].double(), dec.score[:, :1].double(),
                                       idx[:, None].double()], 1).cpu())
        self.call += 1
        return h1 - h0

    @property
    def done(self) -> int:
        """Units run so far."""
        return self.call

    def warmup(self) -> None:
        for _ in range(self.ctx.traffic["warmup_calls"]):
            self.run_unit()

    def release(self) -> None:
        self.model = None

    def check(self, first: int, last: int, control: str = "") -> dict:
        """The numbers `correct` compares, over every clip of `check_calls`
        calls drawn from the seed among the window's, so that every slot
        of the batch is judged."""
        k, n = self.ctx.traffic["check_calls"], self.ctx.geometry.n_frames_test
        gen = torch.Generator().manual_seed(inputs.sub_seed(self.ctx.seed, "check"))
        calls = (first + torch.randint(0, last - first, (k,), generator=gen)
                 ).repeat_interleave(self.clips)
        clips = torch.arange(self.clips).repeat(k)
        dev = self.ctx.device
        batches = calls % self.pool.shape[0]
        frames = torch.stack([self.pool[int(b), int(c) * n:(int(c) + 1) * n]
                              for b, c in zip(batches, clips)]).to(dev)
        ids = self.ids[batches.to(dev), clips.to(dev)]
        W = self.ctx.weights()
        ref = tasks.evaluate(W, self.ctx.geometry, frames, ids, M.FP32)
        if control:
            got = tasks.evaluate(W, self.ctx.geometry, frames, ids, M.Prec(control))
            box, score, idx = got["box"], got["score"], got["idx"]
        else:
            ans = torch.stack([self.answers[int(c)][int(j)] for c, j in zip(calls, clips)]).to(dev)
            box, score, idx = ans[:, :4].float(), ans[:, 4].float(), ans[:, 5].long()
        return C.detection(C.raw_gaps(box, score, ref["cand_boxes"], ref["cand_conf"], idx))
