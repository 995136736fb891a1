"""Single-image grounding evaluation (ReferIt / Flickr / RefCOCO / OTB):
the port of `dcnet_tpu/cli/eval_single.py`.

The correspondence-free baseline (`DCNet.single_image`) runs per image; it
launches no kernel. `--synthetic` takes single frames of the synthetic
clips (`num_frame_k=1`); real data goes through `ReferItDataset`. Prints
`acc,miou`.

Example (data-free, on the CPU):
    DCNET_PLATFORM=cpu python -m dcnet_tpu_torch.cli.eval_single \\
        --synthetic --lstm --mini --size 64
"""

from __future__ import annotations

import os

import torch

from dcnet_tpu_torch.cli.common import (
    base_parser, build_dataset, build_model, check_ported, cli_device,
    config_from_args, load_corpus, restore_weights, setup_logging,
    splice_backbone_weights)
from dcnet_tpu_torch.data.vid import batch_iterator, prefetch_to_device
from dcnet_tpu_torch.data.bert_tokenize import get_bert_tokenizer
from dcnet_tpu_torch.eval.metrics import AverageMeter
from dcnet_tpu_torch.ops.boxes import bbox_iou
from dcnet_tpu_torch.ops.decode import decode_best, inverse_letterbox


def _build_single_dataset(args):
    if args.synthetic:  # single frames of the synthetic clips
        return build_dataset(args, "test", testmode=True, num_frame_k=1)
    from dcnet_tpu_torch.data.referit import ReferItDataset
    index = os.path.join(args.split_root, args.dataset, f"{args.dataset}_test.pth")
    if not os.path.exists(index):
        index = index.replace(".pth", ".json")
    corpus = load_corpus(args)
    ds = ReferItDataset(index, corpus if args.lstm else None, dataset=args.dataset,
                        imsize=args.size, max_query_len=args.time, testmode=True,
                        image_root=args.data_root,
                        bert_tokenizer=None if args.lstm else get_bert_tokenizer(
                            args.bert_model))
    return ds, corpus


def main(argv=None):
    parser = base_parser("dcnet_tpu_torch single-image grounding eval")
    parser.add_argument("--save_plot", action="store_true")
    args = parser.parse_args(argv)
    args.test = True
    if args.savename == "default":
        args.savename = f"model_{args.dataset}_batch{args.batch_size}"
    device = cli_device()
    check_ported(args, "cli.eval_single")
    setup_logging(args.savename, test=True)

    ds, corpus = _build_single_dataset(args)
    cfg = config_from_args(args, corpus_size=len(corpus))
    model = splice_backbone_weights(args, build_model(args, cfg, device))
    if args.resume:
        restore_weights(args.resume, model)

    size = cfg.image_size
    acc, miou = AverageMeter(), AverageMeter()
    batches = prefetch_to_device(batch_iterator(ds, args.batch_size, drop_last=False),
                                 device)
    for i, batch in enumerate(batches):
        images = batch["images"].reshape(-1, *batch["images"].shape[2:])
        word_ids = batch["word_ids"].reshape(-1, batch["word_ids"].shape[-1])
        bbox = torch.clamp(batch["bbox"].reshape(-1, 4), 0, size - 1)
        dec = decode_best(model.single_image(images, word_ids).outbox, cfg)
        ratio, dw, dh = (batch[n].reshape(-1) for n in ("ratio", "dw", "dh"))
        ow, oh = (size - 2 * dw) / ratio, (size - 2 * dh) / ratio
        pred = inverse_letterbox(dec.boxes[:, 0], ratio, dw, dh, ow, oh)
        gt = inverse_letterbox(bbox, ratio, dw, dh, ow, oh)
        iou = bbox_iou(pred, gt).cpu().numpy()
        n = iou.shape[0]
        acc.update(float((iou > 0.5).mean()), n)
        miou.update(float(iou.mean()), n)
        if args.save_plot:
            from dcnet_tpu_torch.eval.visualize import save_grounding_results
            save_grounding_results(
                dec.boxes[:, 0].cpu().numpy(), bbox.cpu().numpy(),
                images.cpu().numpy(), sum(batch.get("phrases", [[]]), []),
                "test", i * args.batch_size,
                save_path=f"./visulizations/{args.savename}/")
    print(f"{acc.avg:.6f},{miou.avg:.6f}")
    return acc.avg


if __name__ == "__main__":
    main()
