"""Training entry point: the port of `dcnet_tpu/cli/train.py`.

Builds the train and test splits (the train split augments), the model
(seeded weights; `--backbone_weights` splices a Darknet `.weights` file),
the RMSprop train state, then runs `--nb_epoch` epochs of `train_step`
(kernel K2 three times and K3 six times a k=2 step) with `validate` after
each (K2 three times a batch) and a checkpoint
`saved_models/<savename>/<epoch>.pth.tar` every epoch (`train/checkpoint.py`).
`--resume DIR` continues from a checkpoint directory's latest epoch,
`--auto_resume` from the run's own, `--pretrain` splices matching weights.
Each epoch reseeds the negative sampling (`seed + 100 + epoch`) and the
dropout streams (`seed + 200 + epoch`) and shuffles by `seed + epoch`, so a
resumed run equals the uninterrupted one. SIGTERM / SIGUSR1 end the epoch
early, checkpoint it and exit. `--profile_dir` writes a torch.profiler
trace of 3 steps (the state is put back afterwards). One process, one card:
`--multihost` and `--devices` above 1 raise (ROADMAP queue A, item 12).

Example (data-free, on the CPU):
    DCNET_PLATFORM=cpu python -m dcnet_tpu_torch.cli.train --synthetic \\
        --lstm --mini --size 64 --batch_size 2 --nb_epoch 2 --max_steps 2
"""

from __future__ import annotations

import copy
import itertools
import logging
import os
import signal

import torch

from dcnet_tpu_torch.cli.common import (
    base_parser, build_dataset, build_model, check_ported, cli_device,
    config_from_args, setup_logging, splice_backbone_weights)
from dcnet_tpu_torch.data.vid import batch_iterator, prefetch_to_device
from dcnet_tpu_torch.train.checkpoint import (
    load_pretrain, restore_checkpoint, save_checkpoint)
from dcnet_tpu_torch.train.loop import flatten_clip_batch, to_device, train_epoch, validate
from dcnet_tpu_torch.train.state import TrainState, create_train_state
from dcnet_tpu_torch.train.step import train_step


def _profile(args, state: TrainState, train_ds, cfg, device) -> None:
    """A torch.profiler trace of 3 train steps on the first batch, written
    to `args.profile_dir`; the model and optimizer are put back after."""
    saved = (copy.deepcopy(state.model.state_dict()),
             copy.deepcopy(state.optimizer.state_dict()),
             copy.deepcopy(state.schedule.state_dict()), state.step)
    batch = next(iter(batch_iterator(train_ds, cfg.batch_size, shuffle=True,
                                     seed=cfg.seed)))
    batch = to_device(flatten_clip_batch(batch), device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(args.profile_dir, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            train_step(state, batch, gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(args.profile_dir, "train_steps.json"))
    state.model.load_state_dict(saved[0])
    state.optimizer.load_state_dict(saved[1])
    state.schedule.load_state_dict(saved[2])
    state.step = saved[3]
    print(f"=> wrote a trace of 3 train steps to {args.profile_dir}")


def main(argv=None) -> TrainState:
    args = base_parser("dcnet_tpu_torch training").parse_args(argv)
    if args.savename == "default":
        args.savename = f"model_{args.dataset}_batch{args.batch_size}"
    device = cli_device()
    check_ported(args)
    setup_logging(args.savename, test=False)
    log = logging.getLogger("dcnet_tpu_torch")

    train_ds, corpus = build_dataset(args, "train")
    val_ds, _ = build_dataset(args, "test")
    cfg = config_from_args(args, corpus_size=len(corpus))
    model = splice_backbone_weights(args, build_model(args, cfg, device))
    steps_per_epoch = max(len(train_ds) // cfg.batch_size, 1)
    state = create_train_state(model, cfg, steps_per_epoch=steps_per_epoch)

    start_epoch, best_acc = 0, -float("inf")
    ckpt_dir = os.path.join("saved_models", args.savename)
    if args.auto_resume and not args.resume:
        try:
            state, start_epoch, best_acc = restore_checkpoint(ckpt_dir, state)
            print(f"=> auto-resumed from {ckpt_dir} at epoch {start_epoch}")
        except FileNotFoundError:
            pass
    if args.resume:
        state, start_epoch, best_acc = restore_checkpoint(args.resume, state)
        print(f"=> resumed from {args.resume} at epoch {start_epoch}")
    elif args.pretrain:
        state = load_pretrain(args.pretrain, state)
        print(f"=> loaded pretrain weights from {args.pretrain}")

    n_params = sum(p.numel() for p in model.parameters())
    print(f"Num of parameters: {n_params}")
    log.info("Num of parameters:%d", n_params)

    # preemption: checkpoint at the next epoch boundary and exit, so that
    # --auto_resume continues the run
    stop = {"flag": False}

    def request_stop(signum, frame):
        stop["flag"] = True
        print(f"=> received signal {signum}; will checkpoint and exit "
              f"at the epoch boundary")

    for sig in (signal.SIGTERM, signal.SIGUSR1):
        try:
            signal.signal(sig, request_stop)
        except (ValueError, OSError):  # not the main thread
            pass

    if args.profile_dir:
        _profile(args, state, train_ds, cfg, device)
    max_steps = args.max_steps or None
    for epoch in range(start_epoch, cfg.nb_epoch):
        train_ds.set_epoch(epoch)
        generator = torch.Generator(device=device).manual_seed(cfg.seed + 100 + epoch)
        torch.manual_seed(cfg.seed + 200 + epoch)  # dropout, every device
        batches = batch_iterator(train_ds, cfg.batch_size, shuffle=True,
                                 seed=cfg.seed + epoch, num_workers=args.workers)
        batches = prefetch_to_device(itertools.islice(batches, max_steps), device)
        train_epoch(state, batches, epoch, print_freq=args.print_freq,
                    max_steps=max_steps, generator=generator,
                    should_stop=lambda: stop["flag"])
        val_batches = batch_iterator(val_ds, cfg.batch_size, num_workers=args.workers)
        result = validate(model, itertools.islice(val_batches, max_steps))
        print(f"accu {result['acc50']:.4f} miou {result['miou']:.4f}", flush=True)
        best_acc = max(best_acc, result["acc50"])
        save_checkpoint(ckpt_dir, state, epoch, best_acc)
        log.info("Best Accu: %f", best_acc)
        if stop["flag"]:
            print(f"=> checkpointed epoch {epoch}; exiting on signal")
            break
    return state


if __name__ == "__main__":
    main()
