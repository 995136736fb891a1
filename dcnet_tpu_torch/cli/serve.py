"""Streaming serving entry point: the port of `dcnet_tpu/cli/serve.py`.

Drives `serving.engine.GroundingEngine` as a process: N concurrent video
streams, each with its own referring phrase, one engine step per frame tick
(the backbone on each new frame, co-attention off the feature rings through
kernel K1, or K4 with `coattn_multiref`), per-stream temporal fusion inside
the step, an optional int8 backbone and trunk (`--quant`, kernel K6) and
the exported bundle (`--export_bundle`, `serving/export.py`). At exit it
prints the mean host ms of each span of `engine.step` over the ticks it
served (`utils.profiling.stage_table`).

Modes:
  --synthetic          N procedural streams (`data.synthetic`, frames
                       written as .npy under ./cache: no cv2 needed)
  --frames_root DIR    real frame directories: DIR/<stream>/*.jpg (or
                       .jpeg / .png through cv2, .npy with numpy), the
                       phrase in DIR/<stream>/phrase.txt
  --export_bundle DIR  after the warm-up, write the serving bundle and exit

`--lstm` serves the BiLSTM encoder, otherwise the frozen BERT encoder
(`--bert_model`); phrases are tokenized with the streams' corpus, as in the
JAX package. `--resume` takes the weights of a checkpoint directory of
`cli.train`, a reference `.pth.tar` or a lock `.npz`. `--state_file`
resumes the stream state from an `.npz` (either package's) and continues at
the tick it stopped at (the streams' frame count), and checkpoints it every
`--state_every` ticks off the serving loop (`_AsyncStateWriter`) and once
at exit. As the JAX serve CLI, it runs one engine without a mesh:
`--devices` and `--multihost` (parsed with the other CLIs' flags) are
logged and change nothing. The engine's mesh (`GroundingEngine(mesh=...)`,
a stream shard per process) is a library option.

Example (data-free, on the CPU):
    DCNET_PLATFORM=cpu python -m dcnet_tpu_torch.cli.serve --synthetic \\
        --lstm --mini --size 64 --emb_size 64 --lstm_hidden 64 \\
        --n_streams 4 --ticks 8
"""

from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np
import torch

from dcnet_tpu_torch.cli.common import (
    base_parser, build_model, cli_device, config_from_args, restore_weights,
    setup_logging, splice_backbone_weights)
from dcnet_tpu_torch.data import transforms as T
from dcnet_tpu_torch.data.vid import read_image
from dcnet_tpu_torch.serving.engine import (
    GroundingEngine, StreamState, cast_params_for_serving, load_stream_state,
    save_stream_state)
from dcnet_tpu_torch.utils.profiling import stage_table

_FRAME_EXTS = (".jpg", ".jpeg", ".png", ".npy")


def parser():
    p = base_parser("dcnet_tpu_torch streaming serving")
    p.add_argument("--n_streams", default=8, type=int,
                   help="concurrent streams (one card)")
    p.add_argument("--ticks", default=32, type=int,
                   help="frame ticks to serve, counted from the first frame "
                        "(0 = until the streams run dry)")
    p.add_argument("--topk", default=5, type=int)
    p.add_argument("--fuse_window", default=5, type=int)
    p.add_argument("--frames_root", default="", type=str,
                   help="serve real streams: <root>/<stream>/*.jpg + "
                        "phrase.txt per stream dir")
    p.add_argument("--quant", action="store_true",
                   help="int8 backbone + trunk (engine.quantize)")
    p.add_argument("--cast_params", action="store_true",
                   help="bf16 weights (cast_params_for_serving)")
    p.add_argument("--export_bundle", default="", type=str,
                   help="write the serving bundle (serving/export.py) here and "
                        "exit")
    p.add_argument("--state_file", default="", type=str,
                   help="resume the stream state from this .npz and "
                        "checkpoint it there periodically")
    p.add_argument("--state_every", default=16, type=int,
                   help="attempt a stream-state checkpoint every N ticks (plus "
                        "a synchronous one at exit); a write in flight skips "
                        "the attempt")
    p.add_argument("--print_every", default=8, type=int)
    p.add_argument("--split_corr", dest="split_corr", action="store_true",
                   default=None,
                   help="split corr_conv ON (serving default is OFF, as in "
                        "the JAX package)")
    p.add_argument("--no_split_corr", dest="split_corr", action="store_false",
                   help="keep split corr_conv OFF (the default)")
    return p


def _frame(path: str, size: int) -> np.ndarray:
    img, *_ = T.letterbox(read_image(path), size)
    return T.normalize_image(img).astype(np.float32)


def synthetic_streams(args):
    """One procedural video per stream (`.npy` frames, seeded by --seed)
    under ./cache: (frames per stream, phrases)."""
    import json

    from dcnet_tpu_torch.data.synthetic import generate_synthetic_vid

    root = os.path.join("cache", f"serve_synth_{args.n_streams}")
    index = generate_synthetic_vid(
        root, "test", num_videos=args.n_streams,
        frames_per_video=max(args.ticks, 8), seed=args.seed, frame_format="npy")
    with open(index) as f:
        videos = json.load(f)
    streams, phrases = [], []
    for vid in videos[:args.n_streams]:
        streams.append([_frame(os.path.join(root, path), args.size)
                        for path, _, _ in vid])
        phrases.append(vid[-1][2])
    return streams, phrases


def dir_streams(args):
    """The stream directories under --frames_root (sorted, at most
    --n_streams): (frames per stream, phrases)."""
    streams, phrases = [], []
    names = sorted(os.listdir(args.frames_root))[:args.n_streams]
    for name in names:
        d = os.path.join(args.frames_root, name)
        if not os.path.isdir(d):
            continue
        with open(os.path.join(d, "phrase.txt")) as f:
            phrases.append(f.read().strip())
        streams.append([_frame(os.path.join(d, fn), args.size)
                        for fn in sorted(os.listdir(d))
                        if fn.lower().endswith(_FRAME_EXTS)])
    return streams, phrases


def _host_copy(state: StreamState) -> StreamState:
    """A copy of the state on the host that the next steps cannot touch
    (the engine writes the rings in place)."""
    def cp(x):
        return x.detach().to("cpu", copy=True)
    return state._replace(
        feat_rings=tuple(cp(x) for x in state.feat_rings),
        language=tuple(cp(x) for x in state.language),
        **{k: cp(getattr(state, k)) for k in
           ("cache_boxes", "cache_scores", "cache_feats", "frames_seen", "word_ids")})


class _AsyncStateWriter:
    """Periodic stream-state checkpoints off the serving loop: `attempt`
    copies the state to the host and writes the `.npz` on a thread, but
    only when the previous write has finished (a large state takes far
    longer to write than a tick; while a write is in flight the attempt,
    copy included, is skipped). `finish` joins the writer and writes once
    more, synchronously."""

    def __init__(self, path: str):
        self.path = path
        self._thread = None

    def attempt(self, state: StreamState) -> bool:
        if self._thread is not None and self._thread.is_alive():
            return False
        host = _host_copy(state)
        self._thread = threading.Thread(target=save_stream_state,
                                        args=(self.path, host), daemon=True)
        self._thread.start()
        return True

    def finish(self, state: StreamState) -> None:
        if self._thread is not None:
            self._thread.join()
        save_stream_state(self.path, state)


def main(argv=None):
    """Serve; returns the final state (None after --export_bundle)."""
    args = parser().parse_args(argv)
    args.test = True
    if args.savename == "default":
        args.savename = f"serve_{args.n_streams}streams"
    device = cli_device()
    setup_logging(args.savename, test=True)
    if args.multihost or args.devices > 1:
        logging.getLogger(__name__).info(
            "--devices %d%s: one engine on one device, no mesh, as the JAX serve CLI "
            "runs", args.devices, " --multihost" if args.multihost else "")

    if args.frames_root:
        from dcnet_tpu_torch.data.corpus import Corpus
        streams, phrases = dir_streams(args)
        corpus = Corpus.build(phrases)
    else:
        from dcnet_tpu_torch.data.synthetic import build_synthetic_corpus
        corpus = build_synthetic_corpus()
        streams, phrases = synthetic_streams(args)
    n = len(streams)
    if n == 0:
        raise SystemExit("no streams found")

    cfg = config_from_args(args, corpus_size=len(corpus))
    # the split corr_conv costs the streaming step: off unless asked for
    cfg = cfg.replace(split_corr_conv=bool(args.split_corr))
    model = splice_backbone_weights(args, build_model(args, cfg, device))
    if args.resume:
        restore_weights(args.resume, model)
    if args.cast_params:
        cast_params_for_serving(model)

    word_ids = np.stack([corpus.tokenize(p, cfg.query_len) for p in phrases])
    engine = GroundingEngine(model, n_streams=n,
                             n_frame=args.num_frame_k if args.num_frame_k > 2 else 5,
                             topk=args.topk, fuse_window=args.fuse_window)
    if args.quant:
        # the trunk's calibration reads one clip of n_frame frames
        per = max(4, engine.n_frame)
        calib = [f for s in streams for f in s[:per]][:32]
        if len(calib) < engine.n_frame:
            raise SystemExit(f"--quant needs >= {engine.n_frame} calibration frames "
                             f"across streams, got {len(calib)}")
        engine.quantize(torch.from_numpy(np.stack(calib)),
                        calib_word_ids=torch.from_numpy(word_ids[:1]))

    if args.export_bundle:
        from dcnet_tpu_torch.serving.export import export_engine
        export_engine(engine, args.export_bundle,
                      warmup_frames=np.stack([s[0] for s in streams]))
        print(f"bundle written to {args.export_bundle}")
        return None

    start = 0
    if args.state_file and os.path.exists(args.state_file):
        state = load_stream_state(args.state_file, device=device)
        start = int(state.frames_seen.max())
        print(f"resumed stream state from {args.state_file} "
              f"(frames_seen={state.frames_seen.tolist()})")
    else:
        state = engine.init_state(torch.from_numpy(word_ids))

    max_ticks = args.ticks or min(len(s) for s in streams)
    writer = _AsyncStateWriter(args.state_file) if args.state_file else None
    served = 0
    t0 = time.perf_counter()
    for t in range(start, max_ticks):
        frames = torch.from_numpy(np.stack([s[min(t, len(s) - 1)] for s in streams]))
        state, fused, raw, score = engine.step(state, frames)
        served += n
        if writer is not None and args.state_every > 0 and (t + 1) % args.state_every == 0:
            writer.attempt(state)
        if (t + 1) % args.print_every == 0 or t == max_ticks - 1:
            box = fused[0].float().cpu().numpy()  # syncs the card
            dt = time.perf_counter() - t0
            print(f"tick {t + 1}/{max_ticks}: {served / dt:.1f} predictions/s, "
                  f"stream0 fused box {box.round(1).tolist()} "
                  f"score {float(score[0]):.3f}", flush=True)
    if writer is not None:
        writer.finish(state)
    print(f"served {served} predictions over {n} streams")
    print(stage_table("engine.step"))
    return state


if __name__ == "__main__":
    main()
