"""Training steps: `train.step.train_step` on batches of k=2 synthetic clips,
a closed loop.

Set-up builds one train state (the model, RMSprop and its schedule) from
the benchmark's weights and drives it through its first `warmup_steps`
steps through the window's own call and feed, on distinct batches; the
reference follows the first three of them. One step of the window, drawn
from the seed among its first `check_window_steps`, is checked too: the
parameters, RMSprop's square averages and the generators' states are
copied before it, and the reference takes that step from the copy. Each step copies its batch
(images, phrases, boxes) from a pinned host pool of `pool_batches`
batches (non-blocking) and reads the step's metrics back to the host, as
the training loop does.
"""

from __future__ import annotations

import contextlib
import time

import torch

from portbench import inputs
from portbench import compare as C
from portbench.reference import model as M
from portbench.reference import tasks

CHECKED_STEPS = 3


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 products in cuBLAS and cuDNN on or off inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Runner:
    def __init__(self, ctx):
        from dcnet_tpu_torch.train.state import create_train_state

        from portbench.program import build_model

        self.ctx = ctx
        g, t, dev = ctx.geometry, ctx.traffic, ctx.device
        self.clips = t["clips"]
        self.items = self.clips
        self.start = ctx.weights()
        model = build_model(g, t, self.start, dev)
        self.state = create_train_state(model, model.cfg)
        n = t["pool_batches"]
        data = inputs.synthetic_clips(inputs.generator(ctx.seed, "clips", dev), n * self.clips,
                                      g.n_frames_train, g.image_size, g.query_len,
                                      g.corpus_size, dev)
        self.pool = []
        per = self.clips * g.n_frames_train
        for b in range(n):
            batch = {}
            for k, v in data.items():
                host = torch.empty(v[b * per:(b + 1) * per].shape, dtype=v.dtype,
                                   pin_memory=dev.type == "cuda")
                host.copy_(v[b * per:(b + 1) * per])
                batch[k] = host
            self.pool.append(batch)
        del data
        self.neg_seed = inputs.sub_seed(ctx.seed, "negatives")
        self.dropout_seed = inputs.sub_seed(ctx.seed, "dropout")
        self.gen = torch.Generator(device=dev).manual_seed(self.neg_seed)
        torch.manual_seed(self.dropout_seed)
        self.step = 0
        self.losses, self.grad, self.change = [], {}, {}
        self.window_step = None    # the checked step of the window (1-based)
        self.before = None         # the state before it
        self.after = {}            # its loss and change norms

    def run_unit(self) -> float:
        from dcnet_tpu_torch.train.step import train_step

        batch = {k: v.to(self.ctx.device, non_blocking=True)
                 for k, v in self.pool[self.step % len(self.pool)].items()}
        checked = self.step + 1 == self.window_step
        if checked:
            self._snapshot()
        h0 = time.perf_counter()
        metrics = train_step(self.state, batch, generator=self.gen)
        h1 = time.perf_counter()
        torch.stack([metrics[k].float() for k in sorted(metrics)]).cpu()   # the read-back
        self.step += 1
        if self.step <= CHECKED_STEPS:
            self.losses.append(float(metrics["loss"]))
            self._record()
        if checked:
            params = [p.detach() for _, p in self.state.model.named_parameters()]
            diffs = torch._foreach_sub(params, [self.before["params"][n] for n in self._names()])
            self.after = {"loss": float(metrics["loss"]),
                          "change": torch.stack(torch._foreach_norm(diffs))}
        return h1 - h0

    def _names(self):
        return [n for n, _ in self.state.model.named_parameters()]

    @torch.no_grad()
    def _snapshot(self) -> None:
        """The state the window's checked step starts from: parameters,
        square averages, the negatives' generator and the default one."""
        model, opt = self.state.model, self.state.optimizer
        dev = self.ctx.device
        self.before = {
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "sq": {n: opt.state[p]["square_avg"].clone() for n, p in model.named_parameters()
                   if p in opt.state},
            "neg": self.gen.get_state(),
            "rng": torch.cuda.get_rng_state(dev) if dev.type == "cuda" else torch.get_rng_state(),
            "batch": self.step % len(self.pool)}

    @torch.no_grad()
    def _record(self) -> None:
        """The first step's gradients as the optimizer took them (from its
        square average, (1 - alpha) d^2 after one step), and each leaf's
        change after the checked steps."""
        model, opt = self.state.model, self.state.optimizer
        if self.step == 1:
            alpha = self.ctx.geometry.rmsprop_alpha
            for name, p in model.named_parameters():
                st = opt.state.get(p)
                if st is not None:
                    self.grad[name] = float((st["square_avg"] / (1 - alpha)).sum().sqrt())
        if self.step == CHECKED_STEPS:
            for name, p in model.named_parameters():
                if name in self.grad:
                    self.change[name] = float((p - self.start[name]).norm())
            self.start = None

    @property
    def done(self) -> int:
        """Units run so far."""
        return self.step

    def warmup(self) -> None:
        for _ in range(max(self.ctx.traffic["warmup_steps"], CHECKED_STEPS)):
            self.run_unit()
        gen = torch.Generator().manual_seed(inputs.sub_seed(self.ctx.seed, "check"))
        self.window_step = self.step + 1 + int(torch.randint(
            0, self.ctx.traffic["check_window_steps"], (1,), generator=gen))

    def release(self) -> None:
        self.state = None

    def check(self, first: int, last: int, control: str = "") -> dict:
        """The numbers `correct` compares: the program's first steps and
        the window's checked step (or, with `control`, the reference's at
        that precision) against the reference's. A window that ended
        before its checked step reads NaN."""
        dev, g = self.ctx.device, self.ctx.geometry
        batches = [{k: v.to(dev) for k, v in self.pool[i % len(self.pool)].items()}
                   for i in range(CHECKED_STEPS)]
        if self.before is None or not self.after:
            nan = float("nan")
            return {k: nan for k in ("loss1_rel", "grad_rel", "change_rel", "step_loss_rel",
                                     "step_change_rel")}
        b = self.before
        window_batch = {k: v.to(dev) for k, v in self.pool[b["batch"]].items()}

        def reference(prec: str) -> dict:
            with tf32(prec == "tf32"):
                out = tasks.train(self.ctx.weights(), g, batches, self.neg_seed,
                                  self.dropout_seed, CHECKED_STEPS, M.Prec(prec))
                W = self.ctx.weights()
                W.update({n: v.clone() for n, v in b["params"].items()})
                sq = {n: b["sq"][n].clone() if n in b["sq"] else torch.zeros_like(v)
                      for n, v in b["params"].items()}
                out.update(tasks.train_step_from(W, sq, g, window_batch, b["neg"], b["rng"],
                                                 M.Prec(prec)))
                return out

        ref = reference("fp32")
        if control:
            got = reference(control)
        else:
            got = {"losses": self.losses, "grad": self.grad, "change": self.change,
                   "step_loss": self.after["loss"],
                   "step_change": dict(zip(b["params"], self.after["change"].tolist()))}
        return C.train_gaps(got, ref)
