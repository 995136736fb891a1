"""The port's BERT language path against the JAX package's, on the CPU.

BERT itself on a tiny geometry (`tests/test_bert.py`'s) and on bert-mini,
with the JAX init's weights carried across by `state_dict_from_jax`: every
hidden state in fp32 within 1e-5 (flax's LayerNorm takes the fast variance
E[x^2] - E[x]^2, torch two passes; the two differ by ~1e-6 here), and in
bf16 each output at most twice as far from JAX's fp32 result as JAX's own
bf16 result, with the same output dtypes (fp32 sentence and context, bf16
`embedded`: flax's LayerNorms carry no dtype). Then the encoder contract,
the tokenizer, DCNet on the BERT path at mini defs and 64 px (one k=2
train step, dropout 0 on both sides through `BertConfig.for_model` and the
config; eval_clip on the lock's weights), the frozen body after RMSprop
steps with weight decay,
`remat_backbone`, a reference-layout BERT state_dict, and the committed
BERT lock (`tests/locks/converge32tinybert.npz`), whose frozen body the
JAX package regenerates from its seed-13 init.
"""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as flax_nn
from flax.linen import normalization as flax_norm

import dcnet_tpu.models.bert as jbert
import dcnet_tpu.ops.correspondence as jcorr
import dcnet_tpu_torch.models.bert as pbert
import dcnet_tpu_torch.ops.correspondence as pcorr
from dcnet_tpu.config import DCNetConfig as JaxConfig
from dcnet_tpu.data import bert_tokenize as jtok
from dcnet_tpu.models import DCNet as JaxDCNet
from dcnet_tpu.models.darknet import mini_backbone_defs as jax_mini_defs
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.data import bert_tokenize as ptok
from dcnet_tpu_torch.models.darknet import mini_backbone_defs
from dcnet_tpu_torch.models.dcnet import DCNet
from dcnet_tpu_torch.train.state import create_train_state
from dcnet_tpu_torch.train.step import train_step
from dcnet_tpu_torch.weights import load_into, seeded_init_, state_dict_from_jax
from tests.test_torch_train import TRAIN, _batch, _exact_variance, _jax_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BERT_LOCK = os.path.join(REPO, "tests", "locks", "converge32tinybert.npz")
TINY = dict(vocab_size=60, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position=40, dropout=0.0)
MINI = dict(hidden_size=128, num_layers=4, num_heads=4, intermediate_size=512,
            dropout=0.0)
GEOMETRIES = {"tiny": TINY, "mini": MINI}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ids(vocab, seed=0, b=3, l=12):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab, (b, l)).astype(np.int32)
    ids[1, 8:] = 0  # a padded phrase
    return ids


def _no_dropout(cls, name, _orig=None):
    """BertConfig.for_model with dropout 0 (both packages' classmethods)."""
    return dataclasses.replace(_orig(name), dropout=0.0)


@pytest.fixture
def bert_dropout_off(monkeypatch):
    for mod in (jbert, pbert):
        orig = mod.BertConfig.for_model
        monkeypatch.setattr(mod.BertConfig, "for_model", classmethod(
            functools.partial(_no_dropout, _orig=orig)))


@functools.lru_cache(maxsize=None)
def _bert_pair(geometry, bf16=False, proj=16):
    """A JAX BertEncoder's init and outputs (and its body's hidden states),
    and the port's encoder with its weights."""
    jdtype, dtype = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jm = jbert.BertEncoder(bert_model="bert-mini", proj_dim=proj, dtype=jdtype)
    ids = _ids(GEOMETRIES[geometry].get("vocab_size", 30522))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbert.BertConfig, "for_model", classmethod(
            lambda cls, n: cls(**GEOMETRIES[geometry])))
        variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ids))
        body = jbert.BertModel(jbert.BertConfig(**GEOMETRIES[geometry]), jdtype)
        with jax.default_matmul_precision("highest"):
            jout = jax.jit(jm.apply)(variables, jnp.asarray(ids))
            jlayers = jax.jit(lambda p, x, m: body.apply(
                {"params": p}, x, attention_mask=m))(
                variables["params"]["bert"], jnp.asarray(ids),
                jnp.asarray((ids != 0).astype(np.int32)))
    sd = state_dict_from_jax({"textmodel": jax.device_get(variables["params"])}, {})
    port = pbert.BertEncoder(proj_dim=proj, dtype=dtype, device="cpu",
                             cfg=pbert.BertConfig(**GEOMETRIES[geometry]))
    port.load_state_dict({k[len("textmodel."):]: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)
    return ids, jout, jlayers, port


@pytest.mark.parametrize("geometry", ["tiny", "mini"])
def test_bert_hidden_states_match_jax(geometry):
    ids, jout, jlayers, port = _bert_pair(geometry)
    t = torch.from_numpy(ids)
    layers = port.hidden_states(t, attention_mask=(t != 0).long())
    assert len(layers) == len(jlayers)
    for i, (h, jh) in enumerate(zip(layers, jlayers)):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-5,
                                   err_msg=f"layer {i}")
    with torch.no_grad():
        out = port(t)
    for name, a, b in zip(("sentence", "context", "embedded"), out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("geometry", ["tiny", "mini"])
def test_bert_bf16_follows_flax_dtype_rules(geometry):
    """In bf16 the sentence and context come out fp32 and `embedded` bf16,
    as flax's do; each is at most twice as far from JAX's fp32 result as
    JAX's own bf16 result is."""
    ids, j32, _, _ = _bert_pair(geometry)
    _, j16, _, port = _bert_pair(geometry, bf16=True)
    with torch.no_grad():
        out = port(torch.from_numpy(ids))
    for name, a, b16, b32 in zip(("sentence", "context", "embedded"), out, j16, j32):
        assert str(a.dtype).split(".")[-1] == str(b16.dtype), name
        ref = np.asarray(b32, np.float64)
        err = np.abs(a.double().numpy() - ref).max()
        jerr = np.abs(np.asarray(b16, np.float64) - ref).max()
        assert err <= 2 * jerr, (name, err, jerr)


def test_bert_encoder_contract():
    """Shapes of bert-mini, a frozen body (no gradient reaches it, it
    requires none) and a trained `proj`; dropout is on in training."""
    enc = pbert.BertEncoder("bert-mini", proj_dim=16, device="cpu")
    seeded_init_(enc, seed=1)
    ids = torch.from_numpy(_ids(1000, b=2, l=20))
    sent, ctx, emb = enc(ids)
    assert sent.shape == (2, 128) and ctx.shape == (2, 20, 128) and emb.shape == (2, 20, 16)
    (sent.square().sum() + emb.square().sum()).backward()
    body = [p for n, p in enc.named_parameters() if not n.startswith("proj.")]
    assert body and all(not p.requires_grad and p.grad is None for p in body)
    assert enc.proj.weight.grad is not None and enc.proj.weight.grad.abs().sum() > 0
    with torch.no_grad():
        assert not torch.equal(enc(ids, train=True)[1], enc(ids, train=False)[1])
    assert pbert.BertConfig.for_model("bert-base-uncased").hidden_size == 768
    assert pbert.BertConfig.for_model("bert-large-uncased").hidden_size == 1024
    assert DCNetConfig(use_lstm=False, bert_model="bert-mini").textdim == 128


def test_tokenizer_matches_jax():
    """The port's tokenizer is the JAX package's offline fallback, which
    the JAX package takes wherever no WordPiece vocab can be fetched."""
    jt = jtok.FallbackBertTokenizer()
    pt = ptok.get_bert_tokenizer("bert-base-uncased")
    assert isinstance(pt, ptok.FallbackBertTokenizer)
    for phrase in ("The small red box, moving LEFT!", "a dog ||| a cat",
                   "x " * 40, "", "naïve café 3rd"):
        for n in (20, 6):
            for a, b in zip(jtok.encode_phrase(jt, phrase, n),
                            ptok.encode_phrase(pt, phrase, n)):
                np.testing.assert_array_equal(a, b)
                assert b.dtype == np.int32 and b.shape == (n,)


BERT_SMALL = dict(TRAIN, use_lstm=False, bert_model="bert-mini")


def filled_variables(model, images, word_ids, seed=0):
    """Seeded numpy values in the shapes of a flax model's variables
    (`jax.eval_shape` of its init: no compile): kernels N(0, 1/fan_in) as
    flax's lecun_normal, embeddings N(0, 1/features), biases, BatchNorm and
    LayerNorm scales and running statistics near their init."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, images, word_ids, train=False))
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name, shape = path[-1].key, x.shape
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "embedding":
            v = rng.randn(*shape) / np.sqrt(shape[-1])
        elif name == "scale":
            v = 1 + 0.1 * rng.randn(*shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("bias", "mean"):
            v = 0.1 * rng.randn(*shape)
        else:  # the BiLSTM's gate weights
            v = rng.uniform(-1, 1, shape) / np.sqrt(shape[-1] // 4)
        return v.astype(x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _jax_bert_dcnet(k=2):
    cfg = JaxConfig(**BERT_SMALL, n_frames_train=k)
    model = JaxDCNet(cfg=cfg, backbone_defs=jax_mini_defs())
    b = _batch(k, seed=0)
    return cfg, model, filled_variables(model, jnp.asarray(b["images"]),
                                        jnp.asarray(b["word_ids"]))


def _port_bert_dcnet(variables, **over):
    cfg = DCNetConfig(**{**BERT_SMALL, **over})
    model = DCNet(cfg, backbone_defs=mini_backbone_defs(), device="cpu")
    load_into(model, state_dict_from_jax(variables["params"], variables["batch_stats"]))
    return cfg, model


@pytest.fixture(scope="module")
def bert_step():
    """JAX's and the port's DCNet on the BERT path from the same weights:
    one k=2 train step (the same deterministic negatives, dropout 0, exact
    BatchNorm variance)."""
    mp = pytest.MonkeyPatch()
    for mod in (jbert, pbert):
        orig = mod.BertConfig.for_model
        mp.setattr(mod.BertConfig, "for_model", classmethod(
            functools.partial(_no_dropout, _orig=orig)))
    mp.setattr(flax_norm, "_compute_stats", functools.partial(
        _exact_variance, flax_norm._compute_stats))
    mp.setattr(jcorr, "_sample_negatives_excluding", lambda rng, pos, n, k: (
        (pos[..., None] + 1 + jnp.arange(k)) % n).astype(jnp.int32))
    mp.setattr(pcorr, "_sample_negatives_excluding", lambda g, pos, n, k: (
        pos.long()[..., None] + 1 + torch.arange(k)) % n)
    try:
        jcfg, jmodel, variables = _jax_bert_dcnet()
        cfg, model = _port_bert_dcnet(variables)
        batch = _batch(2)
        batch["word_ids"] = (batch["word_ids"] * 577 % 29000).astype(np.int32)
        new_state, jmetrics = _jax_step(jmodel, jcfg, variables,
                                        {n: jnp.asarray(v) for n, v in batch.items()})
        pstate = create_train_state(model, cfg, steps_per_epoch=10)
        pmetrics = train_step(pstate, {n: torch.from_numpy(v) for n, v in batch.items()})
    finally:
        mp.undo()
    return dict(jmetrics=jmetrics, pmetrics=pmetrics,
                jgrads=state_dict_from_jax(new_state.opt_state[0], {}), model=model)


def test_bert_dcnet_train_step_matches_jax(bert_step):
    """Losses and metrics at rtol 1e-4; the trained parameters' gradient
    (every one but the frozen body) at relative l2 1e-3 as one vector, and
    `proj`'s, which only the BERT path has, on its own."""
    for part in ("loss", "loss_yolo", "loss_rank", "loss_loc", "loss_interframe",
                 "loss_crossmodal", "miou"):
        np.testing.assert_allclose(float(bert_step["pmetrics"][part]),
                                   float(bert_step["jmetrics"][part]),
                                   rtol=1e-4, atol=1e-5, err_msg=part)
    named = {n: p for n, p in bert_step["model"].named_parameters() if p.requires_grad}
    want = bert_step["jgrads"]
    assert all(n in want for n in named)
    assert all(not p.requires_grad and p.grad is None
               for n, p in bert_step["model"].named_parameters() if n not in named)
    for names in (list(named), ["textmodel.proj.weight", "textmodel.proj.bias"]):
        p = torch.cat([named[n].grad.double().flatten() for n in names])
        j = torch.cat([torch.from_numpy(np.asarray(want[n], np.float64)).flatten()
                       for n in names])
        assert (p - j).norm() <= 1e-3 * j.norm(), names[:2]


def _port_train_model(**over):
    cfg = DCNetConfig(**{**BERT_SMALL, **over})
    model = DCNet(cfg, backbone_defs=mini_backbone_defs(), device="cpu")
    return cfg, seeded_init_(model, seed=3)


def test_frozen_body_unchanged_after_rmsprop_steps(bert_dropout_off):
    """Three RMSprop steps with weight decay 5e-4: every parameter of the
    BERT body keeps its bytes; `proj` and the trunk move."""
    cfg, model = _port_train_model()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, cfg.replace(lr=1e-3), steps_per_epoch=10)
    assert cfg.weight_decay > 0
    batch = {n: torch.from_numpy(v) for n, v in _batch(2).items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        train_step(state, batch, gen)
    body = [n for n in before if n.startswith("textmodel.")
            and not n.startswith("textmodel.proj.")]
    assert len(body) == 5 + 16 * 4  # embeddings + 4 layers of bert-mini
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        assert same == (n in body), n


def test_remat_step_equals_plain_step(bert_dropout_off):
    """`remat_backbone` recomputes the backbone in the backward: the same
    losses, gradients and BatchNorm running statistics, bitwise."""
    results = []
    for remat in (False, True):
        cfg, model = _port_train_model(remat_backbone=remat)
        state = create_train_state(model, cfg, steps_per_epoch=10)
        state.optimizer.step = lambda *a, **k: None  # keep the weights
        batch = {n: torch.from_numpy(v) for n, v in _batch(2).items()}
        m = train_step(state, batch, torch.Generator().manual_seed(0))
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        stats = {n: b.clone() for n, b in model.named_buffers()}
        results.append((m, grads, stats))
    (m0, g0, s0), (m1, g1, s1) = results
    assert float(m0["loss"]) == float(m1["loss"])
    assert g0.keys() == g1.keys() and len(g0) > 100
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert any("visumodel" in n and "running_mean" in n for n in s0)
    for n in s0:
        assert torch.equal(s0[n], s1[n]), n


def test_reference_bert_state_dict_loads_as_jax_maps_it(monkeypatch):
    """A reference-layout state_dict of the BERT path (DDP prefix, BERT
    LayerNorms as gamma/beta, the pooler, no proj) lands in the port where
    the JAX package's `convert_reference_state_dict` puts it; `proj` keeps
    the model's own weights and is reported untouched; the pooler is
    dropped (the JAX package reports it unmatched). A missing key of the
    model raises."""
    from dcnet_tpu.train.checkpoint import convert_reference_state_dict as jconvert
    from dcnet_tpu_torch.train.checkpoint import convert_reference_state_dict

    monkeypatch.setattr(jbert.BertConfig, "for_model",
                        classmethod(lambda cls, n: cls(**MINI)))
    _, _, variables = _jax_bert_dcnet()
    full = state_dict_from_jax(variables["params"], variables["batch_stats"])
    ref = {}
    for k, v in full.items():
        if k.startswith("textmodel.proj."):
            continue
        k = k.replace("LayerNorm.weight", "LayerNorm.gamma").replace(
            "LayerNorm.bias", "LayerNorm.beta")
        ref["module." + k] = torch.from_numpy(np.array(v)) + 0.5
    ref["module.textmodel.pooler.dense.weight"] = torch.zeros(128, 128)
    ref["module.textmodel.pooler.dense.bias"] = torch.zeros(128)

    jparams, jstats, jreport = jconvert(ref, variables["params"],
                                        variables["batch_stats"], strict=False)
    want = state_dict_from_jax(jparams, jstats)
    cfg, model = _port_bert_dcnet(variables)
    converted, report = convert_reference_state_dict(ref, model)
    load_into(model, converted)
    got = model.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert sorted(report.untouched) == ["textmodel.proj.bias", "textmodel.proj.weight"]
    assert sorted(report.skipped) == sorted(
        k[len("module."):] for k in ref if ".pooler." in k)
    assert ("params", "textmodel", "proj", "kernel") in jreport.untouched
    assert sorted(jreport.unmatched) == sorted(report.skipped)  # JAX keeps them out too
    del ref["module.textmodel.encoder.layer.0.output.dense.bias"]
    with pytest.raises(KeyError, match="lacks"):
        convert_reference_state_dict(ref, model)


# ---------------------------------------------------------------------------
# the committed BERT lock
# ---------------------------------------------------------------------------

ROWS, N_FRAME, CENTER = 10, 5, 2


def _restore_bert_lock():
    """(JAX model, cfg, params, batch_stats) of the tiny BERT lock: the
    npz's trees and the frozen body from the seed-13 init of
    `tools/lock_pack.py`'s recipe, checked against the lock's fingerprint."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import lock_pack
    finally:
        sys.path.pop(0)
    import json
    from dcnet_tpu.cli.common import base_parser, build_model, config_from_args
    from dcnet_tpu.data.synthetic import build_synthetic_corpus

    args = base_parser("lock").parse_args(lock_pack.tiny_argv(True))
    cfg = config_from_args(args, corpus_size=len(build_synthetic_corpus()))
    model = build_model(args, cfg)
    p_rng, s_rng, d_rng = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    rngs = {"params": p_rng, "sampling": s_rng, "dropout": d_rng}
    images = jnp.zeros((2, cfg.image_size, cfg.image_size, 3), jnp.float32)
    ids = jnp.zeros((2, cfg.query_len), jnp.int32)
    fresh = jax.eval_shape(lambda: model.init(rngs, images, ids, train=False))

    class Text(flax_nn.Module):
        """The model's text encoder alone, at the model's scope path
        (`textmodel`): flax derives each parameter's key from the root
        key and that path, so its init is the model's."""

        def setup(self):
            self.textmodel = jbert.BertEncoder(
                bert_model=cfg.bert_model, proj_dim=cfg.emb_size, name="textmodel")

        def __call__(self, w):
            return self.textmodel(w)

    text = jax.device_get(jax.jit(lambda: Text().init(rngs, ids))())["params"]
    fresh = {"params": {**fresh["params"], "textmodel": text["textmodel"]},
             "batch_stats": fresh["batch_stats"]}
    z = np.load(BERT_LOCK)
    meta = json.loads(str(z["__meta__"]))
    assert meta["bert"]

    def fill(tree, prefix):
        def leaf(path, x):
            key = "/".join(p.key for p in path)
            if prefix == "params" and key.startswith(lock_pack.FROZEN_PREFIX):
                return np.asarray(x)
            return z[f"{prefix}/{key}"].astype(x.dtype)
        return jax.tree_util.tree_map_with_path(leaf, tree)

    params = fill(fresh["params"], "params")
    got = lock_pack._frozen_fingerprint(lock_pack._flatten(params))
    assert len(got) == len(meta["frozen_fingerprint"]) > 0
    for (gk, gs, gm), (wk, ws, wm) in zip(got, meta["frozen_fingerprint"]):
        assert gk == wk and abs(gs - ws) < 1e-3 and abs(gm - wm) < 1e-6, gk
    return model, cfg, params, fill(fresh["batch_stats"], "bstats")


@pytest.fixture(scope="module")
def bert_lock(tmp_path_factory):
    from dcnet_tpu.data.synthetic import generate_synthetic_vid
    from dcnet_tpu.data.vid import VIDDataset, batch_iterator
    from dcnet_tpu.data.bert_tokenize import get_bert_tokenizer
    from dcnet_tpu.ops.boxes import bbox_iou as jax_bbox_iou
    from dcnet_tpu.ops.decode import decode_best as jax_decode_best
    from dcnet_tpu.ops.decode import inverse_letterbox as jax_inverse_letterbox
    from dcnet_tpu_torch.eval.metrics import AverageMeter
    from dcnet_tpu_torch.ops.boxes import bbox_iou
    from dcnet_tpu_torch.ops.decode import decode_best, inverse_letterbox

    jmodel, jcfg, params, bstats = _restore_bert_lock()
    work = tmp_path_factory.mktemp("bertlock")
    root = str(work / "synthetic")
    generate_synthetic_vid(root, "test", num_videos=32, frames_per_video=8, seed=13)
    ds = VIDDataset(os.path.join(root, "VID_video_level_test.json"), None,
                    split="test", imsize=64, num_frame_k=N_FRAME, max_query_len=20,
                    testmode=True, image_root=root, seed=13,
                    bert_tokenizer=get_bert_tokenizer("bert-mini"))
    ds.chunks = ds.chunks[:ROWS]
    cfg = DCNetConfig(image_size=64, emb_size=256, lstm_hidden=256,
                      word_embedding_size=256, use_lstm=False, bert_model="bert-mini",
                      corpus_size=jcfg.corpus_size)
    port = DCNet(cfg, backbone_defs=mini_backbone_defs(), device="cpu")
    load_into(port, state_dict_from_jax(params, bstats))

    forward = jax.jit(lambda p, s, x, w: jmodel.apply(
        {"params": p, "batch_stats": s}, x, w, n_frame=N_FRAME,
        method=JaxDCNet.eval_clip))
    meters = {n: (AverageMeter(), AverageMeter()) for n in ("jax", "port")}
    first = None
    for batch in batch_iterator(ds, 5, drop_last=False, num_workers=0):
        images = batch["images"].reshape(-1, *batch["images"].shape[2:])
        ids = batch["word_ids"][:, CENTER]
        bbox = np.clip(batch["bbox"][:, CENTER], 0, 63)
        ratio, dw, dh = (batch[k][:, CENTER] for k in ("ratio", "dw", "dh"))
        ow, oh = (64 - 2 * dw) / ratio, (64 - 2 * dh) / ratio
        with jax.default_matmul_precision("highest"):
            jout = forward(params, bstats, jnp.asarray(images), jnp.asarray(ids))
        geo = [jnp.asarray(a) for a in (ratio, dw, dh, ow, oh)]
        jpred = jax_inverse_letterbox(jax_decode_best(jout.outbox, jcfg).boxes[:, 0], *geo)
        jiou = np.asarray(jax_bbox_iou(jpred, jax_inverse_letterbox(jnp.asarray(bbox), *geo)))
        out = port.eval_clip(torch.from_numpy(images), torch.from_numpy(ids))
        first = first or (jax.device_get(jout), out)
        geo = [torch.from_numpy(np.asarray(a, np.float32)) for a in (ratio, dw, dh, ow, oh)]
        pred = inverse_letterbox(decode_best(out.outbox, cfg).boxes[:, 0], *geo)
        iou = bbox_iou(pred, inverse_letterbox(
            torch.from_numpy(bbox.astype(np.float32)), *geo)).numpy()
        for name, v in (("jax", jiou), ("port", iou)):
            meters[name][0].update(float((v > 0.5).mean()), len(v))
            meters[name][1].update(float(v.mean()), len(v))
    ckpt = str(work / "bert_lock.pth.tar")
    torch.save({"epoch": 0, "state_dict": port.state_dict()}, ckpt)
    return dict(scores={k: (a.avg, m.avg, a.count) for k, (a, m) in meters.items()},
                work=work, ckpt=ckpt, first=first)


def test_bert_dcnet_eval_clip_matches_jax(bert_lock):
    """`eval_clip` on the BERT path (the lock's trained weights, mini defs,
    64 px, 5 clips of 5 frames): every output within 1e-4 of JAX's."""
    jout, out = bert_lock["first"]
    for field in ("outbox", "sim_score", "loc_score", "corr_feat"):
        for s in range(3):
            np.testing.assert_allclose(
                getattr(out, field)[s].numpy(), np.asarray(getattr(jout, field)[s]),
                rtol=1e-4, atol=1e-4, err_msg=f"{field}[{s}]")


def test_bert_lock_scores_as_through_jax(bert_lock):
    (jacc, jmiou, n), (acc, miou, pn) = bert_lock["scores"]["jax"], bert_lock["scores"]["port"]
    assert n == pn == ROWS
    assert jmiou > 0.05 and miou > 0.05
    assert abs(acc - jacc) < 1e-6 and abs(miou - jmiou) < 2e-3, (acc, jacc, miou, jmiou)


def test_bert_lock_int8_cli_within_the_lock_limits(bert_lock, monkeypatch):
    """The port's `cli.test` on the carried-across lock: the standard eval
    scores as above, and `--stream_eval --quant --quant_trunk` stays
    within the one-sided limits of the JAX package's BERT lock test
    (mIoU > standard - 0.03, acc > standard - 0.11)."""
    import contextlib
    import io
    import dcnet_tpu_torch.cli.common as pcommon
    import dcnet_tpu_torch.cli.test as ptest

    def limited(*a, **kw):
        ds, corpus = build(*a, **kw)
        ds.chunks = ds.chunks[:ROWS]
        return ds, corpus

    build = pcommon.build_dataset
    monkeypatch.setattr(ptest, "build_dataset", limited)
    monkeypatch.chdir(bert_lock["work"])
    monkeypatch.setenv("DCNET_PLATFORM", "cpu")
    base = ["--synthetic", "--mini", "--size", "64", "--emb_size", "256",
            "--bert_model", "bert-mini", "--num_frame_k", "5", "--batch_size", "5",
            "--workers", "0", "--split_root", str(bert_lock["work"]),
            "--resume", bert_lock["ckpt"], "--savename", "bert_lock"]

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            ptest.main(argv)
        acc, miou = out.getvalue().strip().splitlines()[-1].split(",")
        return float(acc), float(miou)

    acc, miou = run(base)
    jacc, jmiou, _ = bert_lock["scores"]["jax"]
    assert abs(acc - jacc) < 1e-6 and abs(miou - jmiou) < 2e-3
    acc_q, miou_q = run(base + ["--quant", "--quant_trunk", "--calib_frames", "16"])
    assert miou_q > miou - 0.03, (miou, miou_q)
    assert acc_q > acc - 0.11, (acc, acc_q)
