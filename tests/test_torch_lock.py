"""Trained-weights lock: the committed tiny accuracy lock
(`tests/locks/converge32tiny.npz`: emb 256, BiLSTM hidden 256, mini defs,
64 px) scores the same through the port as through the JAX package.

The lock is restored with the JAX package (the npz layout of
`tools/lock_pack.py`), in memory, so this file writes nothing that other test files
share; the weights go to the port through `state_dict_from_jax`. The
`data/synthetic32` test split is regenerated from its seed (13) into a
temporary directory. Ten rows of 5-frame clips run through both
`eval_clip -> decode_best`; acc@0.5 must be equal (1e-6) and mIoU within
2e-3, the tolerances of the JAX package's own lock tests.
"""

import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcnet_tpu.data.synthetic import build_synthetic_corpus, generate_synthetic_vid
from dcnet_tpu.data.vid import VIDDataset, batch_iterator
from dcnet_tpu.models.dcnet import DCNet as JaxDCNetCls
from dcnet_tpu.ops.boxes import bbox_iou as jax_bbox_iou
from dcnet_tpu.ops.decode import decode_best as jax_decode_best
from dcnet_tpu.ops.decode import inverse_letterbox as jax_inverse_letterbox
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.eval.metrics import AverageMeter
from dcnet_tpu_torch.models.darknet import mini_backbone_defs
from dcnet_tpu_torch.models.dcnet import DCNet
from dcnet_tpu_torch.ops.boxes import bbox_iou
from dcnet_tpu_torch.ops.decode import decode_best, inverse_letterbox
from dcnet_tpu_torch.weights import load_into, state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(REPO, "tests", "locks", "converge32tiny.npz")
N_FRAME, CENTER, ROWS, BATCH = 5, 2, 10, 4


def _restore_lock():
    """(JAX model, cfg, params, batch_stats) of the tiny LSTM lock. The
    tree template comes from `jax.eval_shape` of the model's init (shapes
    only), filled from the npz as `tools/lock_pack.py unpack` does."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import lock_pack
    finally:
        sys.path.pop(0)
    from dcnet_tpu.cli.common import base_parser, build_model, config_from_args

    args = base_parser("lock").parse_args(lock_pack.tiny_argv(False))
    cfg = config_from_args(args, corpus_size=len(build_synthetic_corpus()))
    model = build_model(args, cfg)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.zeros((2, cfg.image_size, cfg.image_size, 3), jnp.float32),
        jnp.zeros((2, cfg.query_len), jnp.int32), train=False))
    z = np.load(LOCK)
    assert not json.loads(str(z["__meta__"]))["bert"]

    def rebuild(template, prefix):
        def leaf(path, x):
            key = prefix + "/" + "/".join(p.key for p in path)
            assert z[key].shape == x.shape, key
            return z[key].astype(x.dtype)
        return jax.tree_util.tree_map_with_path(leaf, template)

    return (model, cfg, rebuild(shapes["params"], "params"),
            rebuild(shapes["batch_stats"], "bstats"))


@pytest.fixture(scope="module")
def lock_scores(tmp_path_factory):
    jmodel, jcfg, params, bstats = _restore_lock()
    root = str(tmp_path_factory.mktemp("synthetic32"))
    generate_synthetic_vid(root, "test", num_videos=32, frames_per_video=8,
                           seed=13)
    ds = VIDDataset(os.path.join(root, "VID_video_level_test.json"),
                    build_synthetic_corpus(), split="test", imsize=64,
                    num_frame_k=N_FRAME, max_query_len=20, testmode=True,
                    image_root=root, seed=13)
    ds.chunks = ds.chunks[:ROWS]

    cfg = DCNetConfig(image_size=64, emb_size=256, lstm_hidden=256,
                      word_embedding_size=256, corpus_size=jcfg.corpus_size)
    port = DCNet(cfg, backbone_defs=mini_backbone_defs(), device="cpu")
    load_into(port, state_dict_from_jax(params, bstats))

    forward = jax.jit(lambda p, s, x, w: jmodel.apply(
        {"params": p, "batch_stats": s}, x, w, n_frame=N_FRAME,
        method=JaxDCNetCls.eval_clip))
    meters = {name: (AverageMeter(), AverageMeter()) for name in ("jax", "port")}
    for batch in batch_iterator(ds, BATCH, drop_last=False, num_workers=0):
        images = batch["images"].reshape(-1, *batch["images"].shape[2:])
        ids = batch["word_ids"][:, CENTER]
        bbox = np.clip(batch["bbox"][:, CENTER], 0, cfg.image_size - 1)
        ratio, dw, dh = (batch[k][:, CENTER] for k in ("ratio", "dw", "dh"))
        ow, oh = (cfg.image_size - 2 * dw) / ratio, (cfg.image_size - 2 * dh) / ratio

        with jax.default_matmul_precision("highest"):
            jout = forward(params, bstats, jnp.asarray(images), jnp.asarray(ids))
        geo = [jnp.asarray(a) for a in (ratio, dw, dh, ow, oh)]
        jpred = jax_inverse_letterbox(jax_decode_best(jout.outbox, jcfg).boxes[:, 0], *geo)
        jiou = np.asarray(jax_bbox_iou(jpred, jax_inverse_letterbox(jnp.asarray(bbox), *geo)))

        out = port.eval_clip(torch.from_numpy(images), torch.from_numpy(ids))
        geo = [torch.from_numpy(np.asarray(a, np.float32)) for a in (ratio, dw, dh, ow, oh)]
        pred = inverse_letterbox(decode_best(out.outbox, cfg).boxes[:, 0], *geo)
        iou = bbox_iou(pred, inverse_letterbox(
            torch.from_numpy(bbox.astype(np.float32)), *geo)).numpy()

        for name, v in (("jax", jiou), ("port", iou)):
            acc, miou = meters[name]
            acc.update(float((v > 0.5).mean()), len(v))
            miou.update(float(v.mean()), len(v))
    return {k: (a.avg, m.avg, a.count) for k, (a, m) in meters.items()}


def test_lock_acc50_equal(lock_scores):
    (jacc, _, n), (acc, _, m) = lock_scores["jax"], lock_scores["port"]
    assert n == m == ROWS
    assert abs(acc - jacc) < 1e-6, lock_scores


def test_lock_miou_close(lock_scores):
    (_, jmiou, _), (_, miou, _) = lock_scores["jax"], lock_scores["port"]
    assert jmiou > 0.05, lock_scores  # trained weights ground something
    assert abs(miou - jmiou) < 2e-3, lock_scores
