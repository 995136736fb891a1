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
trace of 3 steps (the state is put back afterwards) and prints its
summary (`utils.profiling.summarize_trace`), with the device and idle
time under each of the train step's spans.

Data parallelism (`parallel.mesh`): `--devices N` runs N processes, one a
card (0: every card; on the CPU one process), this one rank 0 and the
others spawned; under torchrun (which `--multihost` needs) each process is
one rank of its launch; `--devices 1` makes a group of one. Each rank
trains on its rows of every global batch (`--batch_size`, as in the JAX
package, divisible by the ranks; `batch_iterator(batch_shards,
batch_shard)`: every rank takes len // batch_size steps, the batches of
the one-process run) through DistributedDataParallel,
with the global batch's BatchNorm moments; the logged metrics are averaged
over the ranks; only rank 0 writes checkpoints; a resume is read by every
rank and broadcast from rank 0; a stop signal to any rank stops every rank
at the same step (`mesh.any_rank`).

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
import sys

import torch

from dcnet_tpu_torch.cli.common import (
    base_parser, build_dataset, build_model, cli_device, config_from_args,
    setup_logging, splice_backbone_weights, start_processes)
from dcnet_tpu_torch.data.vid import batch_iterator, prefetch_to_device
from dcnet_tpu_torch.parallel import mesh
from dcnet_tpu_torch.train.checkpoint import (
    load_pretrain, restore_checkpoint, save_checkpoint)
from dcnet_tpu_torch.train.loop import flatten_clip_batch, to_device, train_epoch, validate
from dcnet_tpu_torch.train.state import TrainState, create_train_state
from dcnet_tpu_torch.train.step import train_step
from dcnet_tpu_torch.utils.profiling import device_trace, summarize_trace


def _profile(args, state: TrainState, train_ds, cfg, device) -> None:
    """A torch.profiler trace (`utils.profiling.device_trace`) of 3 train
    steps on the first batch, written to `args.profile_dir` by rank 0 (every rank takes the steps on its rows
    of the batch: they run collectives); the model and optimizer are put
    back after."""
    saved = (copy.deepcopy(state.model.state_dict()),
             copy.deepcopy(state.optimizer.state_dict()),
             copy.deepcopy(state.schedule.state_dict()), state.step)
    batch = next(iter(batch_iterator(train_ds, cfg.batch_size, shuffle=True,
                                     seed=cfg.seed, **mesh.batch_slice_args())))
    batch = to_device(flatten_clip_batch(batch), device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    writes = mesh.world()[1] == 0
    with device_trace(args.profile_dir if writes else None, device, "train_steps.json"):
        for _ in range(3):
            train_step(state, batch, gen)
    state.model.load_state_dict(saved[0])
    state.optimizer.load_state_dict(saved[1])
    state.schedule.load_state_dict(saved[2])
    state.step = saved[3]
    if writes:
        print(f"=> wrote a trace of 3 train steps to {args.profile_dir}")
        print(summarize_trace(args.profile_dir))


def main(argv=None) -> TrainState:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = base_parser("dcnet_tpu_torch training").parse_args(argv)
    if args.savename == "default":
        args.savename = f"model_{args.dataset}_batch{args.batch_size}"
    device = cli_device()
    launched = start_processes(main, argv, args, device)
    if launched is not None:
        return launched[0]
    try:
        return _train(args, device)
    finally:
        if mesh.launched() or args.devices == 1:
            mesh.shutdown()


def _train(args, device) -> TrainState:
    size, rank = mesh.world()
    setup_logging(args.savename, test=False)
    log = logging.getLogger("dcnet_tpu_torch")

    for turn in (0, 1):  # rank 0 writes a missing synthetic split first
        if (rank == 0) == (turn == 0):
            train_ds, corpus = build_dataset(args, "train")
            val_ds, _ = build_dataset(args, "test")
        mesh.barrier()
    cfg = config_from_args(args, corpus_size=len(corpus))
    model = splice_backbone_weights(args, build_model(args, cfg, device))
    if cfg.batch_size % size:
        raise ValueError(f"--batch_size {cfg.batch_size} (the global batch) over "
                         f"{size} processes: make it a multiple of {size}")
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
    if mesh.world()[0] > 1 or args.devices == 1 or mesh.launched():
        # every rank starts from rank 0's weights and optimizer state
        mesh.replicate_state(mesh.model_and_optimizer_tensors(model, state.optimizer))
        state.ddp = mesh.wrap_ddp(model, device)

    n_params = sum(p.numel() for p in model.parameters())
    if rank == 0:
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
    rows = mesh.batch_slice_args()  # this rank's rows of each global batch
    for epoch in range(start_epoch, cfg.nb_epoch):
        train_ds.set_epoch(epoch)
        # each rank draws its own negatives and dropout masks
        generator = torch.Generator(device=device).manual_seed(
            cfg.seed + 100 + epoch + 1000 * rank)
        torch.manual_seed(cfg.seed + 200 + epoch + 1000 * rank)  # dropout, every device
        batches = batch_iterator(train_ds, cfg.batch_size, shuffle=True,
                                 seed=cfg.seed + epoch, num_workers=args.workers, **rows)
        batches = prefetch_to_device(itertools.islice(batches, max_steps), device)
        train_epoch(state, batches, epoch, print_freq=args.print_freq,
                    max_steps=max_steps, generator=generator,
                    should_stop=lambda: stop["flag"])
        val_batches = batch_iterator(val_ds, cfg.batch_size, num_workers=args.workers,
                                     **rows)
        result = validate(model, itertools.islice(val_batches, max_steps))
        if rank == 0:
            print(f"accu {result['acc50']:.4f} miou {result['miou']:.4f}", flush=True)
        best_acc = max(best_acc, result["acc50"])
        if rank == 0:
            save_checkpoint(ckpt_dir, state, epoch, best_acc)
        mesh.barrier()
        log.info("Best Accu: %f", best_acc)
        if mesh.any_rank(stop["flag"]):
            print(f"=> checkpointed epoch {epoch}; exiting on signal")
            break
    return state


if __name__ == "__main__":
    main()
