"""Precision probes of the PyTorch/CUDA port on one CUDA card.

    python3 precision_probe.py k3 [--runs 5]
        K3 (the co-attention backward) in fp32 at the train step's shapes
        (B=16, C=512, P=169 and 1024) against the plain version in float64,
        beside the plain version in fp32; then `chip_smoke.py`'s check of
        K2 and K3 on the full-width model's own inputs (fp32 K3 against
        float64, `k3_check`), repeated on `--runs` batches, each run's
        worst errors, shares of the limits, or its failure.
    python3 precision_probe.py train-losses [--widths 24,64,512,1024]
        One k=2 train step of a mini model per width and dtype (bf16,
        fp32): the card with the kernels, the card with the kernels' plain
        versions in their place, and the CPU, from the same weights and
        clips (dropout 0, the same negatives); the largest relative loss
        difference of each pair.

Prints one JSON line per measurement. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def probe_k3(runs: int) -> None:
    import chip_smoke as cs
    from dcnet_tpu_torch.kernels import coattn
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.train.loop import flatten_clip_batch, to_device
    from dcnet_tpu_torch.train.state import create_train_state

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    for p in (169, 1024):
        q, kv = cs._rows(gen, 16, p, 512).to(dev), cs._rows(gen, 16, p, 512).to(dev)
        g = torch.randn(16, p, 512, generator=gen).to(dev)
        got = coattn.attend_bwd(q, kv, 10.0, g)
        exact = coattn.attend_bwd_plain(q.double(), kv.double(), 10.0, g.double())
        plain = coattn.attend_bwd_plain(q, kv, 10.0, g)
        for name, a, w, pl in zip(("dq", "dkv"), got, exact, plain):
            print(json.dumps({
                "P": p, "out": name,
                "kernel_vs_f64_rel": ((a.double() - w).norm() / w.norm()).item(),
                "kernel_vs_f64_max": (a.double() - w).abs().max().item(),
                "plain32_vs_f64_rel": ((pl.double() - w).norm() / w.norm()).item(),
                "plain32_vs_f64_max": (pl.double() - w).abs().max().item()}), flush=True)
    cfg = cs.full_width_config()
    model, _, _ = cs.seeded_model(cfg, dev)
    state0 = {n: v.detach().cpu().clone() for n, v in model.state_dict().items()}
    del model
    for run in range(runs):
        m = DCNet(cfg, backbone_defs=cs._defs(), device=dev)
        m.load_state_dict(state0)
        batch = to_device(flatten_clip_batch(cs.synthetic_clips(
            np.random.RandomState(1 + run), cs.TRAIN_B, cfg.n_frames_train,
            cfg.image_size, cfg.query_len)), dev)
        try:
            res = cs.check_k2_k3_on_model(create_train_state(m, cfg), batch)
        except AssertionError as e:
            res = {"failed": str(e)[:400]}
        print(json.dumps({"run": run, **res}), flush=True)


def _negatives(generator, pos_idx, num_items, neg_n):
    """The neg_n items after the positive: the same on every device."""
    steps = torch.arange(1, neg_n + 1, device=pos_idx.device)
    return (pos_idx.long()[..., None] + steps) % num_items


def probe_train_losses(widths) -> None:
    from dcnet_tpu_torch.config import DCNetConfig
    from dcnet_tpu_torch.kernels import coattn
    from dcnet_tpu_torch.models.darknet import mini_backbone_defs
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.ops import correspondence
    from dcnet_tpu_torch.train.state import create_train_state
    from dcnet_tpu_torch.train.step import train_step
    from dcnet_tpu_torch.weights import seeded_init_

    correspondence._sample_negatives_excluding = _negatives
    launch, bwd = coattn._launch_attend, coattn.attend_bwd

    def plain_launch(q, kv, t, pair):
        if pair:
            return coattn.attend_plain(q, kv, t), coattn.attend_plain(kv, q, t)
        return coattn.attend_plain(q, kv, t)

    for dtype in ("bfloat16", "float32"):
        for c in widths:
            cfg = DCNetConfig(image_size=64, corpus_size=50, emb_size=c, lstm_hidden=c,
                              word_embedding_size=64, n_frames_train=2,
                              compute_dtype=dtype, jemb_dropout=0.0, input_dropout=0.0)
            gen = torch.Generator().manual_seed(20)
            batch = {"images": torch.rand(4, 64, 64, 3, generator=gen),
                     "word_ids": torch.randint(1, 50, (4, 20), generator=gen),
                     "bbox": torch.tensor([[4.0, 6.0, 40.0, 50.0]] * 4)}
            losses = {}
            for name, dev, plain in (("card", "cuda", False), ("card_plain", "cuda", True),
                                     ("cpu", "cpu", False)):
                if plain:
                    coattn._launch_attend, coattn.attend_bwd = plain_launch, coattn.attend_bwd_plain
                try:
                    m = seeded_init_(DCNet(cfg, backbone_defs=mini_backbone_defs(),
                                           device=dev), seed=0)
                    metrics = train_step(create_train_state(m, cfg), batch)
                finally:
                    coattn._launch_attend, coattn.attend_bwd = launch, bwd
                losses[name] = {k: float(v) for k, v in metrics.items()
                                if k.startswith("loss")}

            def rel(a, b):
                return max(abs(losses[a][k] - w) / abs(w) for k, w in losses[b].items())

            print(json.dumps({"dtype": dtype, "C": c, "card_vs_cpu": rel("card", "cpu"),
                              "card_vs_card_plain": rel("card", "card_plain"),
                              "card_plain_vs_cpu": rel("card_plain", "cpu"),
                              "losses": losses}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("probe", choices=("k3", "train-losses"))
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--widths", default="24,64,512,1024")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("precision_probe: torch.cuda.is_available() is False; these probes "
              "measure the kernels on a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.probe == "k3":
        probe_k3(args.runs)
    else:
        probe_train_losses([int(c) for c in args.widths.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
