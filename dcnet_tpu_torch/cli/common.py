"""Shared plumbing of the port's command-line entry points: the port of
`dcnet_tpu/cli/common.py`.

`base_parser` takes the JAX CLIs' flags, `config_from_args` maps them onto
the port's `DCNetConfig`, `build_dataset` opens the synthetic or the
reference VID layout (with the corpus, or BERT's tokenizer without
`--lstm`), `build_model` makes the model on the CLI's device with seeded
weights, `splice_backbone_weights` loads a Darknet `.weights` file and
`restore_weights` the weights of a checkpoint directory of `cli.train`, a
reference `.pth.tar` or a committed lock `.npz`.

Device: the CLIs run on the CUDA card. `DCNET_PLATFORM=cpu` (the variable
the JAX CLIs read) runs them on the CPU; without a card and without it they
raise. Processes (`processes`, `start_processes`): cli.train and cli.test
--data_parallel run one process a card (`--devices N`, 0 = every card;
torchrun's launch, which `--multihost` needs), the others one process
(`check_ported`).
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Tuple

import torch

from dcnet_tpu_torch import default_device
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.data.bert_tokenize import get_bert_tokenizer
from dcnet_tpu_torch.data.corpus import Corpus
from dcnet_tpu_torch.data.synthetic import build_synthetic_corpus, generate_synthetic_vid
from dcnet_tpu_torch.data.vid import VIDDataset
from dcnet_tpu_torch.models.darknet import mini_backbone_defs
from dcnet_tpu_torch.models.dcnet import DCNet
from dcnet_tpu_torch.parallel import mesh
from dcnet_tpu_torch.train.checkpoint import checkpoint_path, load_reference_checkpoint
from dcnet_tpu_torch.weights import (
    load_lock_into, seeded_init_, splice_darknet_weights)


def cli_device() -> torch.device:
    """The device a CLI runs on: `DCNET_PLATFORM` unset (or cuda/gpu) means
    the CUDA card, which must be present; `cpu` means the CPU. A rank of a
    data-parallel launch takes the card of its local rank."""
    platform = os.environ.get("DCNET_PLATFORM", "").lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "cuda", "gpu"):
        raise ValueError(f"DCNET_PLATFORM={platform!r}: the port runs on 'cuda' "
                         "(the default) or 'cpu'")
    if mesh.launched() and torch.cuda.is_available():
        torch.cuda.set_device(mesh.local_rank())
    return default_device()


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--workers", default=8, type=int,
                   help="host decode threads")
    p.add_argument("--nb_epoch", default=100, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--power", default=0.9, type=float, help="lr poly power")
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--size", default=256, type=int)
    p.add_argument("--anchor_imsize", default=416, type=int)
    p.add_argument("--data_root", default="./ln_data/", type=str)
    p.add_argument("--split_root", default="data", type=str)
    p.add_argument("--dataset", default="VID", type=str)
    p.add_argument("--time", default=20, type=int, help="max query length")
    p.add_argument("--emb_size", default=512, type=int)
    p.add_argument("--lstm_hidden", default=512, type=int,
                   help="BiLSTM hidden size; the word embedding width "
                        "follows it")
    p.add_argument("--resume", default="", type=str,
                   help="a checkpoint directory of cli.train (train: the full "
                        "state; eval: its weights), or for the eval CLIs a "
                        "reference .pth.tar or a lock .npz (tools/lock_pack.py)")
    p.add_argument("--pretrain", default="", type=str)
    p.add_argument("--optimizer", default="RMSprop", type=str)
    p.add_argument("--print_freq", "-p", default=100, type=int)
    p.add_argument("--savename", default="default", type=str)
    p.add_argument("--seed", default=13, type=int)
    p.add_argument("--bert_model", default="bert-base-uncased", type=str)
    p.add_argument("--test", action="store_true")
    p.add_argument("--light", action="store_true")
    p.add_argument("--lstm", action="store_true")
    p.add_argument("--num_frame_k", default=2, type=int)
    p.add_argument("--backbone_weights", default="", type=str,
                   help="darknet .weights file for backbone init")
    p.add_argument("--synthetic", action="store_true",
                   help="generate synthetic clips (no dataset needed)")
    p.add_argument("--mini", action="store_true",
                   help="tiny backbone for smoke runs")
    p.add_argument("--devices", default=0, type=int,
                   help="data-parallel processes, one a card (0 = every card, "
                        "one process on the CPU; 1 = a group of one)")
    p.add_argument("--max_steps", default=0, type=int,
                   help="cap steps per epoch (0 = no cap)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute dtype")
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from the run's checkpoint dir if present")
    p.add_argument("--profile_dir", default="", type=str,
                   help="write a torch.profiler trace of 3 train steps here")
    p.add_argument("--multihost", action="store_true",
                   help="the processes of a torchrun launch over hosts (its "
                        "environment gives the ranks)")
    return p


def check_ported(args, cli: str = "this CLI") -> None:
    """Raise for the process options in a CLI that runs one process (every
    one but cli.train and cli.test --data_parallel): more than one card,
    or --multihost, would otherwise silently run one."""
    if args.multihost or args.devices > 1 or mesh.launched():
        raise ValueError(f"{cli} runs one process: --devices above 1, --multihost "
                         f"and torchrun apply to cli.train and cli.test --data_parallel")


def processes(args, device: torch.device) -> int:
    """The data-parallel processes a run asks for: torchrun's world (which
    --multihost needs), else --devices (0: every card, or one process on
    the CPU)."""
    if mesh.launched():
        size = int(os.environ["WORLD_SIZE"])
        if args.devices not in (0, size):
            raise ValueError(f"--devices {args.devices} under a launch of {size} "
                             f"processes")
        return size
    if args.multihost:
        raise ValueError("--multihost runs under torchrun (RANK, WORLD_SIZE, "
                         "LOCAL_RANK and MASTER_ADDR/MASTER_PORT in the environment)")
    if args.devices > 0:
        if device.type == "cuda" and args.devices > torch.cuda.device_count():
            raise ValueError(f"--devices {args.devices}: {torch.cuda.device_count()} "
                             f"CUDA devices")
        return args.devices
    return torch.cuda.device_count() if device.type == "cuda" else 1


def start_processes(main, argv, args, device: torch.device):
    """The data-parallel start of cli.train / cli.test: None where this
    process runs on (joined to the group, or alone), else the result of
    `main` run as N processes (`parallel.mesh.launch`, this one rank 0).
    A group is made for a launch, for torchrun, and for --devices 1 (a
    group of one); the default on one card or the CPU runs without."""
    n = processes(args, device)
    if mesh.launched() or (n == 1 and args.devices == 1):
        mesh.init_distributed(device)
        return None
    if n > 1:
        return (mesh.launch(main, argv, n),)
    return None


def setup_logging(savename: str, test: bool) -> None:
    os.makedirs("./logs", exist_ok=True)
    suffix = "_test" if test else ""
    logging.basicConfig(
        level=logging.DEBUG, filename=f"./logs/{savename}{suffix}",
        filemode="a+", format="%(asctime)-15s %(levelname)-8s %(message)s")


def config_from_args(args, corpus_size: int = 0) -> DCNetConfig:
    return DCNetConfig(
        dataset=args.dataset,
        image_size=args.size,
        anchor_imsize=args.anchor_imsize,
        emb_size=args.emb_size,
        query_len=args.time,
        n_frames_train=args.num_frame_k if not args.test else 2,
        n_frames_test=args.num_frame_k if args.test else 5,
        light=args.light,
        use_lstm=args.lstm,
        lstm_hidden=args.lstm_hidden,
        word_embedding_size=args.lstm_hidden,
        bert_model=args.bert_model,
        corpus_size=corpus_size,
        lr=args.lr,
        poly_power=args.power,
        nb_epoch=args.nb_epoch,
        batch_size=args.batch_size,
        optimizer=args.optimizer.lower(),
        seed=args.seed,
        compute_dtype="bfloat16" if args.bf16 else "float32",
    )


def build_dataset(args, split: str, testmode: bool = False,
                  num_frame_k: Optional[int] = None
                  ) -> Tuple[VIDDataset, Corpus]:
    """The synthetic split under `<split_root>/synthetic` (written as .jpg
    frames from `--seed` where its index is missing; a split written
    beforehand in .npy frames is read as it is), or the reference VID
    layout under `<split_root>/<dataset>` with frames under `--data_root`."""
    k = num_frame_k if num_frame_k is not None else args.num_frame_k
    if args.synthetic:
        root = os.path.join(args.split_root, "synthetic")
        os.makedirs(root, exist_ok=True)
        index = os.path.join(root, f"VID_video_level_{split}.json")
        if not os.path.exists(index):
            generate_synthetic_vid(
                root, split, num_videos=8, frames_per_video=8, seed=args.seed)
        corpus = build_synthetic_corpus()
        image_root = root
    else:
        index = os.path.join(args.split_root, args.dataset,
                             f"VID_video_level_{split}.pth")
        if not os.path.exists(index):
            alt = index.replace(".pth", ".json")
            index = alt if os.path.exists(alt) else index
        corpus = load_corpus(args)
        image_root = args.data_root
    tok = None if args.lstm else get_bert_tokenizer(args.bert_model)
    ds = VIDDataset(index, corpus if args.lstm else None, split=split,
                    imsize=args.size, num_frame_k=k, max_query_len=args.time,
                    testmode=testmode, image_root=image_root, seed=args.seed,
                    bert_tokenizer=tok)
    return ds, corpus


def load_corpus(args) -> Corpus:
    """`<split_root>/<dataset>/corpus.pth` (reference pickle) or `.json`;
    the BERT path, which tokenizes with its own ids, runs without one."""
    from dcnet_tpu_torch.data.corpus import load_reference_corpus

    path = os.path.join(args.split_root, args.dataset, "corpus.pth")
    if os.path.exists(path):
        return load_reference_corpus(path)
    if os.path.exists(path.replace(".pth", ".json")):
        return Corpus.load(path.replace(".pth", ".json"))
    if not args.lstm:
        return Corpus()
    raise FileNotFoundError(path)


def build_model(args, cfg: DCNetConfig, device: torch.device) -> DCNet:
    """The model on `device` with seeded weights (`seeded_init_(cfg.seed)`);
    `splice_backbone_weights` and `restore_weights` replace them."""
    defs = mini_backbone_defs() if args.mini else None
    model = DCNet(cfg, backbone_defs=defs, device=device)
    return seeded_init_(model, seed=cfg.seed)


def splice_backbone_weights(args, model: DCNet) -> DCNet:
    """Load darknet .weights into the backbone (not with --mini)."""
    if args.backbone_weights and not args.mini:
        splice_darknet_weights(model, args.backbone_weights)
    return model


def restore_weights(path: str, model: DCNet) -> DCNet:
    """`--resume` of the eval CLIs, weights only: a lock `.npz`, a port
    checkpoint directory (its latest epoch), or one reference `.pth.tar` /
    `.pth` file (its `state_dict`, or the file's dict itself; BERT
    LayerNorms as gamma/beta and the pooler taken as the reference wrote
    them). An orbax checkpoint directory of the JAX package raises."""
    if os.path.isdir(path):
        path = checkpoint_path(path)
    if path.endswith(".npz"):
        load_lock_into(model, path, light=model.cfg.light)
        return model
    load_reference_checkpoint(path, model)
    return model
