"""Video-level evaluation and the temporal cache: the port of
`dcnet_tpu/cli/test.py`.

The standard eval recomputes every window: `eval_clip` on each n-frame clip
(kernel K1: 12 launches a call), `decode_best`, inverse letterbox, IoU
against the center frame's box. `--stream_eval` runs the backbone once per
frame and `eval_features` over the windows (12 K1 launches a call).
`--cache` writes the top-k cache as one `cache.npz` (the JAX package's
keys), `--ref_cache_format` also the reference's per-frame `.pth` files,
and `--post_process` fuses the cache per video and scores the fused boxes.
`--quant` runs the stream eval on the int8 backbone (`ops/quant.py`, kernel
K6), calibrated on the first `--calib_frames` distinct frames of the split
or read from `--quant_params` (written there when the file is missing);
`--quant_trunk` also runs the trunk convs in int8, calibrated on a float
`eval_clip` of the first clip. `--coattn_batch_refs` and `--coattn_int8`
select the batched-reference and int8-logit co-attention (einsums, no K1).
Prints `acc,miou` and, with `--post_process`, `post_process: acc,miou`.
Frames go through the C++ host loader (`dcnet_tpu_torch.native`) where it
builds and reads them (`DCNET_NO_NATIVE=1` keeps the numpy path; the
pixels are the same): a clip in one call, and in the stream eval a
video's frames in one call.
Without `--lstm` the model reads phrases through the frozen BERT encoder
(`--bert_model`). `--resume` takes the weights of a checkpoint directory
of `cli.train` (its latest epoch), a reference `.pth.tar` or a lock `.npz`.
`--data_parallel` evaluates on one process a card (`--devices N`, 0 = every
card; torchrun's launch): the standard eval gives each rank its shard of
the clips (`--batch_size` is the global batch), the stream eval its share
of the videos, and rank 0 gathers the results in the split's order and
prints and writes them.

Example (data-free, on the CPU):
    DCNET_PLATFORM=cpu python -m dcnet_tpu_torch.cli.test --synthetic \\
        --lstm --mini --size 64 --num_frame_k 5 --post_process
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from dcnet_tpu_torch.cli.common import (
    base_parser, build_dataset, build_model, check_ported, cli_device,
    config_from_args, restore_weights, setup_logging, splice_backbone_weights,
    start_processes)
from dcnet_tpu_torch.data.vid import batch_iterator, letterbox_frames, prefetch_to_device
from dcnet_tpu_torch.eval.metrics import AverageMeter
from dcnet_tpu_torch.eval.temporal import FrameCache, build_frame_cache, fuse_per_video
from dcnet_tpu_torch.ops.boxes import bbox_iou
from dcnet_tpu_torch.ops.decode import decode_best, inverse_letterbox
from dcnet_tpu_torch.parallel import mesh


def parser():
    p = base_parser("dcnet_tpu_torch video-level evaluation")
    p.add_argument("--cache", action="store_true",
                   help="write the temporal top-k cache")
    p.add_argument("--post_process", action="store_true",
                   help="run temporal fusion over the cache")
    p.add_argument("--topk", default=5, type=int)
    p.add_argument("--cache_dir", default="./cache", type=str)
    p.add_argument("--ref_cache_format", action="store_true",
                   help="with --cache, also write the reference's per-frame "
                        ".pth files")
    p.add_argument("--data_parallel", action="store_true",
                   help="evaluate on --devices processes, one a card (0 = every "
                        "card), the clips sharded over them")
    p.add_argument("--save_plot", action="store_true",
                   help="write qualitative JPEGs (needs cv2)")
    p.add_argument("--stream_eval", action="store_true",
                   help="run the backbone once per frame and reuse its "
                        "features across the overlapping windows")
    p.add_argument("--quant", action="store_true",
                   help="int8 post-training-quantized backbone, calibrated "
                        "on the first frames of the split; implies "
                        "--stream_eval")
    p.add_argument("--calib_frames", default=32, type=int,
                   help="calibration frames for --quant")
    p.add_argument("--quant_params", default="", type=str,
                   help="with --quant: read the int8 backbone from this .npz "
                        "if it exists, else calibrate and write it there")
    p.add_argument("--quant_trunk", action="store_true",
                   help="with --quant: also the trunk convs in int8 "
                        "(cfg.trunk_quant)")
    p.add_argument("--coattn_batch_refs", action="store_true",
                   help="every reference frame in one batched co-attention "
                        "einsum (cfg.coattn_batch_refs)")
    p.add_argument("--coattn_int8", action="store_true",
                   help="int8 co-attention logits (cfg.coattn_int8_logits)")
    p.add_argument("--no_split_corr", action="store_true",
                   help="disable the split corr_conv center-half hoisting "
                        "(cfg.split_corr_conv)")
    return p


def _check_options(args, device: torch.device) -> None:
    if not args.data_parallel:
        check_ported(args, "cli.test without --data_parallel")
    if args.stream_eval and (args.cache or args.ref_cache_format):
        raise ValueError("--cache is written by the standard eval; run it "
                         "without --stream_eval")


def split_order(lengths) -> np.ndarray:
    """The permutation that puts the rows rank r of W took (the split's
    rows r, r + W, r + 2W, ...; `lengths[r]` of them), concatenated in rank
    order, back in the split's order."""
    w = len(lengths)
    index = np.concatenate([r + w * np.arange(n) for r, n in enumerate(lengths)])
    return np.argsort(index, kind="stable")


def _reorder(parts, perm: np.ndarray):
    """Every rank's rows (`parts`: arrays, tensors or lists) concatenated
    and permuted by `perm`."""
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)[torch.from_numpy(perm)]
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts)[perm]
    flat = [x for p in parts for x in p]
    return [flat[i] for i in perm]


def _cat(rows) -> FrameCache:
    return FrameCache(*(torch.cat([getattr(c, f) for c in rows])
                        for f in FrameCache._fields))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    if args.quant:
        args.stream_eval = True
    if args.num_frame_k == 2:
        args.num_frame_k = 5  # the test default
    args.test = True
    if args.savename == "default":
        args.savename = f"model_{args.dataset}_batch{args.batch_size}"
    device = cli_device()
    _check_options(args, device)
    if args.data_parallel:
        launched = start_processes(main, argv, args, device)
        if launched is not None:
            return launched[0]
    try:
        return _evaluate(args, device)
    finally:
        if mesh.launched() or (args.data_parallel and args.devices == 1):
            mesh.shutdown()


def _evaluate(args, device):
    setup_logging(args.savename, test=True)
    rank = mesh.world()[1]
    for turn in (0, 1):  # rank 0 writes a missing synthetic split first
        if (rank == 0) == (turn == 0):
            ds, corpus = build_dataset(args, "test", testmode=True)
        mesh.barrier()
    cfg = config_from_args(args, corpus_size=len(corpus))
    cfg = cfg.replace(coattn_batch_refs=args.coattn_batch_refs,
                      coattn_int8_logits=args.coattn_int8,
                      split_corr_conv=not args.no_split_corr)
    model = splice_backbone_weights(args, build_model(args, cfg, device))
    if args.resume:
        restore_weights(args.resume, model)

    if args.stream_eval:
        return _stream_eval(args, ds, cfg, model)

    k = args.num_frame_k
    center = k // 2
    size = cfg.image_size
    size_w, rank = mesh.world()
    want_cache = args.cache or args.post_process
    ious, cache_rows, vid_rows, gt_rows, path_rows = [], [], [], [], []
    batches = prefetch_to_device(
        batch_iterator(ds, max(args.batch_size // size_w, 1), drop_last=False,
                       num_workers=args.workers, **mesh.shard_args()), device)
    for batch in batches:
        images = batch["images"].reshape(-1, *batch["images"].shape[2:])
        out = model.eval_clip(images, batch["word_ids"][:, center], n_frame=k)
        bbox = torch.clamp(batch["bbox"][:, center], 0, size - 1)
        dec = decode_best(out.outbox, cfg)
        ratio, dw, dh = (batch[n][:, center] for n in ("ratio", "dw", "dh"))
        ow, oh = (size - 2 * dw) / ratio, (size - 2 * dh) / ratio
        pred = inverse_letterbox(dec.boxes[:, 0], ratio, dw, dh, ow, oh)
        gt = inverse_letterbox(bbox, ratio, dw, dh, ow, oh)
        iou = bbox_iou(pred, gt).cpu().numpy()
        n = iou.shape[0]
        ious.append(iou)

        if args.save_plot:
            from dcnet_tpu_torch.eval.visualize import save_grounding_results
            phrases = [p[center] for p in batch.get("phrases", [])] or [""]
            save_grounding_results(
                dec.boxes[:, 0].cpu().numpy(), bbox.cpu().numpy(),
                batch["images"][:, center].cpu().numpy(), phrases, "test",
                sum(len(x) for x in ious) - n,
                save_path=f"./visulizations/{args.savename}/")

        if want_cache:
            cache_rows.append(build_frame_cache(out.outbox, out.corr_feat,
                                                args.topk, cfg))
            vid_rows.append(batch["video_id"].cpu().numpy().astype(np.int32))
            host = [x.cpu().numpy() for x in (bbox, ratio, dw, dh)]
            for ii in range(n):
                gt_rows.append((host[0][ii], float(host[1][ii]),
                                float(host[2][ii]), float(host[3][ii])))
                path_rows.append(batch["paths"][ii][center])

    ious = np.concatenate(ious) if ious else np.zeros((0,), np.float32)
    full = _cat(cache_rows) if cache_rows else None
    if size_w > 1:  # rank 0 puts every rank's clips back in the split's order
        mine = (ious, None if full is None else tuple(x.cpu() for x in full),
                np.concatenate(vid_rows) if vid_rows else None, gt_rows, path_rows)
        parts = mesh.gather_to_rank0(mine)
        if rank != 0:
            return None
        perm = split_order([len(p[0]) for p in parts])
        ious = _reorder([p[0] for p in parts], perm)
        if want_cache:
            full = FrameCache(*(_reorder([p[1][i] for p in parts], perm).to(device)
                                for i in range(3)))
            vid_rows = [_reorder([p[2] for p in parts], perm)]
            gt_rows = _reorder([p[3] for p in parts], perm)
            path_rows = _reorder([p[4] for p in parts], perm)
    acc, miou = AverageMeter(), AverageMeter()
    if len(ious):
        acc.update(float((ious > 0.5).mean()), len(ious))
        miou.update(float(ious.mean()), len(ious))
    print(f"{acc.avg:.6f},{miou.avg:.6f}")

    if args.cache and full is not None:
        from dcnet_tpu_torch.cli.post_process import save_cache_npz
        save_cache_npz(
            os.path.join(args.cache_dir, args.savename, "cache.npz"), full,
            np.stack([g[0] for g in gt_rows]),
            np.asarray([g[1] for g in gt_rows], np.float32),
            np.asarray([g[2] for g in gt_rows], np.float32),
            np.asarray([g[3] for g in gt_rows], np.float32),
            video_ids=np.concatenate(vid_rows))
        if args.ref_cache_format:
            from dcnet_tpu_torch.eval.ref_cache import write_reference_cache
            geo = torch.tensor([g[1:] for g in gt_rows], dtype=torch.float32,
                               device=full.boxes.device)
            r, dw_a, dh_a = (geo[:, i:i + 1] for i in range(3))
            orig = inverse_letterbox(full.boxes, r, dw_a, dh_a,
                                     (size - 2 * dw_a) / r, (size - 2 * dh_a) / r)
            write_reference_cache(os.path.join(args.cache_dir, args.savename),
                                  path_rows, FrameCache(orig, full.scores, full.feats))

    if args.post_process and full is not None:
        fused = fuse_per_video(full, np.concatenate(vid_rows), ref_frames=k)
        _print_fused(fused, gt_rows, size, gt_in_letterbox=True)
    return acc.avg


def _print_fused(fused: torch.Tensor, gt_rows, size: int, gt_in_letterbox: bool) -> None:
    """Score fused boxes row by row against (gt box, ratio, dw, dh) and
    print the `post_process:` line. The gt box is letterboxed (standard
    eval) or already in original coordinates (stream eval)."""
    acc, miou = AverageMeter(), AverageMeter()
    for t, (gt_box, ratio, dw, dh) in enumerate(gt_rows):
        geo = [torch.tensor(v, dtype=torch.float32, device=fused.device)
               for v in (ratio, dw, dh, (size - 2 * dw) / ratio, (size - 2 * dh) / ratio)]
        pred = inverse_letterbox(fused[t], *geo)
        gt = torch.as_tensor(np.asarray(gt_box), dtype=torch.float32, device=fused.device)
        if gt_in_letterbox:
            gt = inverse_letterbox(gt, *geo)
        iou = float(bbox_iou(pred[None], gt[None])[0])
        acc.update(float(iou > 0.5))
        miou.update(iou)
    print(f"post_process: {acc.avg:.6f},{miou.avg:.6f}")


def _calibration_frames(ds, n: int) -> np.ndarray:
    """The first `n` distinct frames of the split, letterboxed and
    normalized as the eval feeds them: (n, S, S, 3) fp32."""
    seen = []
    for row in ds.chunks:
        for p in row[0]:
            if p not in seen:
                seen.append(p)
            if len(seen) >= n:
                break
        if len(seen) >= n:
            break
    return letterbox_frames([os.path.join(ds.image_root, p) for p in seen], ds.imsize,
                            ds.use_native)[0]


def _quantize(args, ds, model, k: int):
    """--quant: the int8 backbone's qparams (read from --quant_params, or
    calibrated on the split's first frames and written there), and with
    --quant_trunk the trunk convs calibrated on a float eval_clip of the
    first clip and switched to int8. Returns the qparams."""
    from dcnet_tpu_torch.ops import quant as Q
    dev = model.device
    if args.quant_params and os.path.exists(args.quant_params):
        qparams = Q.load_qparams(args.quant_params, device=dev)
    else:
        calib = torch.from_numpy(_calibration_frames(ds, args.calib_frames))
        qparams = Q.quantize_model_backbone(model, calib.to(dev))
        if args.quant_params:
            Q.save_qparams(args.quant_params, qparams)
    if args.quant_trunk:
        s0 = ds[0]
        images = torch.from_numpy(np.asarray(s0["images"], np.float32)).to(dev)
        ids = torch.from_numpy(np.asarray(s0["word_ids"][k // 2:k // 2 + 1])).to(dev)
        Q.calibrate_trunk(model, lambda m: m.eval_clip(images, ids, n_frame=k))
        Q.trunk_quant_variant(model, "int8")
    return qparams


def _stream_eval(args, ds, cfg, model):
    """Feature-cached video eval: the backbone runs once per frame and the
    overlapping windows reuse its mapped features through `eval_features`,
    which consumes the features `eval_clip` would compute. With --quant the
    backbone is the int8 one (`_quantize`)."""
    k = args.num_frame_k
    center = k // 2
    cb = max(args.batch_size // mesh.world()[0], 1)   # trunk batch (centers)
    fb = cb * k                    # backbone batch (frames)
    dev = model.device
    size = cfg.image_size
    if args.quant:
        from dcnet_tpu_torch.ops.quant import quant_extract_features
        qparams = _quantize(args, ds, model, k)

        def extract(frames):
            return quant_extract_features(model, qparams, frames)
    else:
        extract = model.extract_features

    by_video = {}
    for row in ds.chunks:
        by_video.setdefault(row[3], []).append(row)
    size_w, rank = mesh.world()
    videos = list(by_video.items())[rank::size_w]  # this rank's share

    done = []  # per video: (ious, fused_gt, cache rows, video id rows)
    for vid, rows in videos:
        # rows are consecutive windows: the first window's frames, then the
        # last frame of each later window
        paths = list(rows[0][0]) + [r[0][-1] for r in rows[1:]]
        # decode once per frame: the video's frames in one host loader call
        frames, ratios, dws, dhs = letterbox_frames(
            [os.path.join(ds.image_root, p) for p in paths], ds.imsize, ds.use_native)
        metas = list(zip(ratios, dws, dhs))
        frames = torch.from_numpy(frames)
        parts = [extract(frames[s:s + fb].to(dev))
                 for s in range(0, frames.shape[0], fb)]
        feats = [torch.cat([p[i] for p in parts]) for i in range(3)]

        n_centers = len(rows)
        win = torch.arange(n_centers)[:, None] + torch.arange(k)[None]  # (N, k)
        ids = torch.from_numpy(np.stack([ds._tokenize(r[2][center].lower())[0]
                                         for r in rows]).astype(np.int64))
        gts = np.stack([np.asarray(r[1][center], np.float64) for r in rows])

        ious, fused_gt, cache_rows, vid_rows = [], [], [], []
        for s0 in range(0, n_centers, cb):
            sel = win[s0:s0 + cb].to(dev)
            n = sel.shape[0]
            per_frame = [f[sel] for f in feats]          # (n, k, g, g, C)
            out = model.eval_features(per_frame, ids[s0:s0 + cb].to(dev))
            dec = decode_best(out.outbox, cfg)
            for j in range(n):
                ratio, dw, dh = metas[s0 + j + center]
                geo = [torch.tensor(v, dtype=torch.float32, device=dev) for v in
                       (ratio, dw, dh, (size - 2 * dw) / ratio, (size - 2 * dh) / ratio)]
                pred = inverse_letterbox(dec.boxes[j, 0], *geo)
                gt = torch.as_tensor(gts[s0 + j], dtype=torch.float32, device=dev)
                ious.append(float(bbox_iou(pred[None], gt[None])[0]))
                fused_gt.append((gts[s0 + j], ratio, dw, dh))
            if args.post_process:
                cache = build_frame_cache(out.outbox, out.corr_feat, args.topk, cfg)
                cache_rows.append(cache if size_w == 1 else
                                  FrameCache(*(x.cpu() for x in cache)))
                vid_rows.append(np.full((n,), vid, np.int32))
        done.append((ious, fused_gt, cache_rows, vid_rows))

    if size_w > 1:  # rank 0 puts every rank's videos back in the split's order
        parts = mesh.gather_to_rank0(done)
        if rank != 0:
            return None
        done = _reorder(parts, split_order([len(p) for p in parts]))
    acc, miou = AverageMeter(), AverageMeter()
    for iou in (x for d in done for x in d[0]):
        acc.update(float(iou > 0.5))
        miou.update(iou)
    print(f"{acc.avg:.6f},{miou.avg:.6f}")

    cache_rows = [c for d in done for c in d[2]]
    if args.post_process and cache_rows:
        cache = _cat(cache_rows)
        fused = fuse_per_video(FrameCache(*(x.to(dev) for x in cache)),
                               np.concatenate([v for d in done for v in d[3]]),
                               ref_frames=k)
        _print_fused(fused, [g for d in done for g in d[1]], size, gt_in_letterbox=False)
    return acc.avg

if __name__ == "__main__":
    main()
