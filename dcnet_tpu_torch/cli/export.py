"""Checkpoint conversion between the port's checkpoints and the reference's
`.pth.tar` layout: the port of `dcnet_tpu/cli/export.py`.

The reference persists `{epoch, state_dict, best_loss, optimizer}`; the
port's checkpoint directories (`<epoch>.pth.tar`, `train/checkpoint.py`)
hold a superset of that wrapper, in the same key namespace. This CLI
converts either way:

    # a port checkpoint directory (or a lock .npz) -> a reference .pth.tar
    python -m dcnet_tpu_torch.cli.export --synthetic --lstm --mini --size 64 \\
        --resume ./saved_models/run1 --out run1.pth.tar

    # a reference .pth.tar -> a port checkpoint directory
    python -m dcnet_tpu_torch.cli.export --synthetic --lstm --mini --size 64 \\
        --from_reference model.pth.tar --out ./saved_models/imported

The model flags (`--mini`, `--size`, `--emb_size`, `--lstm`, ...) give
the model the weights load into. The `.pth.tar` written holds the
reference's keys (`export_reference_state_dict`: the model's state_dict
without the BatchNorm counters), `epoch` and `best_loss`. An orbax
directory of the JAX package raises, naming the route through the JAX
package (`train.checkpoint.checkpoint_path`).
"""

from __future__ import annotations

import os

import torch

from dcnet_tpu_torch.cli.common import (
    base_parser, build_dataset, build_model, check_ported, cli_device,
    config_from_args, restore_weights)
from dcnet_tpu_torch.train.checkpoint import (
    checkpoint_epochs, export_reference_state_dict, load_reference_checkpoint,
    save_checkpoint)
from dcnet_tpu_torch.train.state import create_train_state


def main(argv=None) -> str:
    """Convert; returns the path written."""
    parser = base_parser("dcnet_tpu_torch <-> reference checkpoint converter")
    parser.add_argument("--out", required=True, type=str,
                        help="output path (.pth.tar, or a port checkpoint directory "
                             "with --from_reference)")
    parser.add_argument("--from_reference", default="", type=str,
                        help="ingest this reference .pth.tar instead of exporting")
    parser.add_argument("--epoch", default=0, type=int,
                        help="epoch number recorded in the output")
    args = parser.parse_args(argv)
    check_ported(args, "cli.export")
    device = cli_device()

    _, corpus = build_dataset(args, "test", testmode=True)
    cfg = config_from_args(args, corpus_size=len(corpus))
    model = build_model(args, cfg, device)

    if args.from_reference:
        report = load_reference_checkpoint(args.from_reference, model)
        print(f"=> converted {args.from_reference}: {report}")
        state = create_train_state(model, cfg, steps_per_epoch=1)
        path = save_checkpoint(args.out, state, epoch=args.epoch, best_acc=0.0)
        print(f"=> wrote the port checkpoint {path}")
        return path

    if args.resume:
        restore_weights(args.resume, model)
        if os.path.isdir(args.resume) and not args.epoch:
            args.epoch = checkpoint_epochs(args.resume)[-1]
    sd = {k: torch.from_numpy(v) for k, v in export_reference_state_dict(model).items()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save({"epoch": args.epoch, "state_dict": sd, "best_loss": 0.0}, args.out)
    print(f"=> wrote reference-layout checkpoint ({len(sd)} tensors) to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
