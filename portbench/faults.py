"""Faults planted in the program under a run, for the tests that show the
comparison catches them and for reading a fault's numbers on the card
(`portbench.readings --fault`). Each is a context manager that patches
the program and restores it. The benchmark's own runs plant none."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator


@contextlib.contextmanager
def _patched(owner, name: str, make: Callable) -> Iterator[None]:
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def serve_answer():
    """Every stream's raw box moved 16 px right where the tick produces it."""
    import torch
    from dcnet_tpu_torch.serving.engine import GroundingEngine

    def make(step):
        def altered(self, state, frames):
            state, fused, raw, score = step(self, state, frames)
            return state, fused, raw + torch.tensor([16.0, 0, 16.0, 0], device=raw.device), score
        return altered
    return _patched(GroundingEngine, "step", make)


def _runner_up(outbox, cfg):
    """The decode of the second-highest confidence in place of the highest."""
    import torch
    from dcnet_tpu_torch.ops import decode

    order = torch.sort(decode.flatten_conf(outbox), dim=1, descending=True, stable=True).indices
    return decode.decode_indices(outbox, order[:, 1:2], cfg)


def serve_second_raw():
    """The tick's raw answer decoded at the runner-up candidate."""
    from dcnet_tpu_torch.serving import engine

    return _patched(engine, "decode_best", lambda old: _runner_up)


def serve_second_fused():
    """The fusion picks the cache entry with the second-highest fused
    score."""
    import torch
    from dcnet_tpu_torch.serving.engine import GroundingEngine

    def make(fuse):
        def second(self, boxes, scores, feats, seen):
            n, wnd, k = scores.shape
            c = wnd // 2
            f32 = feats.float()
            sim = torch.einsum("nic,nrjc->nirj", f32[:, c], f32)
            picked = torch.gather(scores[:, None].expand(n, k, wnd, k), 3,
                                  torch.argmax(sim, dim=3)[..., None])[..., 0]
            w = torch.softmax(sim.max(dim=3).values, dim=2)
            age = torch.arange(wnd - 1, -1, -1, device=seen.device)
            valid = (seen[:, None] > age[None, :]).to(w.dtype)
            fused = torch.sum(w * valid[:, None, :] * picked, dim=2)
            pick = torch.sort(fused, dim=1, descending=True, stable=True).indices[:, 1]
            return boxes[torch.arange(n, device=boxes.device), c, pick]
        return second
    return _patched(GroundingEngine, "_fuse", make)


def serve_stuck():
    """The tick returns the state it was given (rings written in place, the
    slot, caches and counts not advanced)."""
    from dcnet_tpu_torch.serving.engine import GroundingEngine

    def make(step):
        def stuck(self, state, frames):
            _, fused, raw, score = step(self, state, frames)
            return state, fused, raw, score
        return stuck
    return _patched(GroundingEngine, "step", make)


def eval_answer():
    """Every clip's box moved 16 px down where the decode produces it."""
    import torch
    from dcnet_tpu_torch.ops import decode

    def make(best):
        def altered(outbox, cfg):
            d = best(outbox, cfg)
            return d._replace(boxes=d.boxes + torch.tensor([0, 16.0, 0, 16.0],
                                                           device=d.boxes.device))
        return altered
    return _patched(decode, "decode_best", make)


def eval_second():
    """Every clip's answer decoded at the runner-up candidate."""
    from dcnet_tpu_torch.ops import decode

    return _patched(decode, "decode_best", lambda old: _runner_up)


def eval_half():
    """Half of the batch left out: the first half's outputs stand for all."""
    import torch
    from dcnet_tpu_torch.models.dcnet import DCNet

    def make(eval_clip):
        def half(self, images, word_ids, n_frame=5):
            b = word_ids.shape[0]
            out = eval_clip(self, images[:(b // 2) * n_frame], word_ids[:b // 2], n_frame)
            return type(out)(*[[torch.cat([x, x])[:b] for x in f] for f in out])
        return half
    return _patched(DCNet, "eval_clip", make)


def train_stuck():
    """The optimizer's step does nothing: the state comes back unchanged."""
    import torch
    return _patched(torch.optim.RMSprop, "step", lambda old: lambda self, closure=None: None)


def train_half():
    """Half of the batch left out: the step's mean is taken over the rest."""
    from dcnet_tpu_torch.train import step as S

    def make(train_step):
        def half(state, batch, generator=None):
            n = batch["images"].shape[0] // 2
            return train_step(state, {k: v[:n] for k, v in batch.items()}, generator)
        return half
    return _patched(S, "train_step", make)


def train_answer():
    """The step's loss reported 10% high where it is produced."""
    from dcnet_tpu_torch.train import step as S

    def make(train_step):
        def altered(state, batch, generator=None):
            m = train_step(state, batch, generator)
            return dict(m, loss=m["loss"] * 1.1)
        return altered
    return _patched(S, "train_step", make)


FAULTS: Dict[str, Callable] = {f.__name__: f for f in (
    serve_answer, serve_second_raw, serve_second_fused, serve_stuck, eval_answer, eval_second,
    eval_half, train_stuck, train_half, train_answer)}
