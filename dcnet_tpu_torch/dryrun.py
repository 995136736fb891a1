"""The multi-process dry run: the port of `__graft_entry__.py::dryrun_multichip`.

`dryrun_multichip(n)` runs n ranks (`parallel.mesh.launch`: this process
rank 0, the rest spawned) on a (data, model) mesh and drives the three
parallel paths at once, as the JAX function does on its device mesh:

1. one train step (forward, five losses, backward, RMSprop) with the batch
   over `data` (DistributedDataParallel over the data group) and, on a
   model axis of 2 (n >= 4 and even), `cfg.tp_internals`: the
   co-attention's query rows split over the model group (K2 / K3 on row
   windows on a card); the loss must be finite and the step count 1;
2. `eval_clip` with the clip batch over `data` (K1 on row windows under
   `tp_internals`);
3. one tick of the serving engine with n streams over `data`
   (`GroundingEngine(mesh=...)`, outputs all-gathered).

Rank 0 prints the JAX function's three `ok` lines. The model is the JAX
function's flagship configuration (BiLSTM, emb 512) at 64 px on the mini
backbone, or on Darknet-53 with `full_backbone`, weights from a seed. On
the CPU the ranks join by gloo; on cards by NCCL, one card a rank, or by
gloo over CUDA tensors where the ranks outnumber the cards (they share
them).

    python -m dcnet_tpu_torch.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from dcnet_tpu_torch import default_device
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.parallel import mesh


def flagship_config(image_size: int = 64) -> DCNetConfig:
    """`__graft_entry__._flagship`'s configuration."""
    return DCNetConfig(
        image_size=image_size, corpus_size=1000, use_lstm=True,
        interframe_top_k=min(30, (image_size // 32) ** 4),
        interframe_neg_n=min(10, (image_size // 32) ** 2 - 1),
        crossmodal_neg_n=min(5, (image_size // 32) ** 2 - 1))


def _rank(argv: list) -> Optional[list]:
    """One rank of the dry run (argv: n, device type, backend, full
    backbone 0/1). Returns the lines rank 0 printed."""
    from dcnet_tpu_torch.models.darknet import mini_backbone_defs
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.serving.engine import GroundingEngine
    from dcnet_tpu_torch.train.state import create_train_state
    from dcnet_tpu_torch.train.step import train_step
    from dcnet_tpu_torch.weights import seeded_init_

    n, kind, backend, full = int(argv[0]), argv[1], argv[2], argv[3] == "1"
    if kind == "cuda":
        dev = torch.device("cuda", mesh.local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    mesh.init_distributed(dev, backend=backend)
    try:
        n_model = 2 if n >= 4 and n % 2 == 0 else 1
        m = mesh.make_mesh(n // n_model, n_model)
        cfg = flagship_config(64).replace(tp_internals=n_model > 1)
        torch.manual_seed(0)   # equal dropout masks and negatives in a model group
        model = seeded_init_(DCNet(cfg, backbone_defs=None if full else mini_backbone_defs(),
                                   device=dev), seed=0)
        lines = []

        def say(line: str) -> None:
            if mesh.world()[1] == 0:
                print(line, flush=True)
                lines.append(line)

        rng = np.random.RandomState(0)
        clips = n                       # 2 frames a clip
        images = rng.rand(2 * clips, 64, 64, 3).astype(np.float32)
        word_ids = rng.randint(1, 1000, (2 * clips, 20)).astype(np.int64)
        bbox = np.stack([rng.rand(2 * clips) * 20, rng.rand(2 * clips) * 20,
                         rng.rand(2 * clips) * 20 + 30, rng.rand(2 * clips) * 20 + 30],
                        1).astype(np.float32)
        per = 2 * clips // m.n_data
        rows = slice(m.data_rank * per, (m.data_rank + 1) * per)
        batch = {"images": torch.from_numpy(images[rows]),
                 "word_ids": torch.from_numpy(word_ids[rows]),
                 "bbox": torch.from_numpy(bbox[rows])}
        state = create_train_state(model, cfg, steps_per_epoch=10)
        state.ddp = mesh.wrap_ddp(model, dev)
        loss = float(mesh.mean_over_ranks(train_step(state, batch))["loss"])
        if not np.isfinite(loss) or state.step != 1:
            raise AssertionError(f"dry-run train step: loss {loss}, step {state.step}")
        say(f"dryrun_multichip({n}): loss={loss:.4f} ok")

        n_frame = 5
        eval_images = rng.rand(n_frame * clips, 64, 64, 3).astype(np.float32)
        eval_words = rng.randint(1, 1000, (clips, 20)).astype(np.int64)
        per = clips // m.n_data
        mine = slice(m.data_rank * per, (m.data_rank + 1) * per)
        out = model.eval_clip(
            torch.from_numpy(eval_images[mine.start * n_frame:mine.stop * n_frame]),
            torch.from_numpy(eval_words[mine]))
        peak = max(float(o.max()) for o in out.outbox)
        if not np.isfinite(peak):
            raise AssertionError(f"non-finite eval output {peak}")
        say(f"dryrun_multichip({n}): eval_clip sharded B={clips} ok")

        engine = GroundingEngine(model, n_streams=n, n_frame=n_frame, topk=3,
                                 fuse_window=3, mesh=m)
        frames = rng.rand(n, 64, 64, 3).astype(np.float32)
        sstate = engine.init_state(rng.randint(1, 1000, (n, 20)).astype(np.int64))
        sstate, _, raw, _ = engine.step(sstate, frames)
        raw_peak = float(raw.max())
        if raw.shape[0] != n or not np.isfinite(raw_peak):
            raise AssertionError(f"serving step: {tuple(raw.shape)} boxes, peak {raw_peak}")
        say(f"dryrun_multichip({n}): serving step streams={n} ok")
        return lines
    finally:
        mesh.shutdown()


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     full_backbone: bool = False) -> list:
    """Run the dry run on `n_devices` ranks: on the cards (the default;
    raises where there is none) or, with `device="cpu"`, on the CPU (gloo).
    Returns the lines rank 0 printed; raises if a rank failed."""
    kind = device or "cuda"
    if kind == "cuda":
        default_device()
        backend = "nccl" if torch.cuda.device_count() >= n_devices else "gloo"
    else:
        backend = "gloo"
    return mesh.launch(_rank, [str(n_devices), kind, backend,
                               "1" if full_backbone else "0"], n_devices)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?",
                    default=int(os.environ.get("GRAFT_DEVICES", "8")))
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None)
    ap.add_argument("--full_backbone", action="store_true",
                    help="Darknet-53 instead of the mini backbone")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.full_backbone)


if __name__ == "__main__":
    main()
