"""Per-module parity of the port against the JAX package, on the CPU in
fp32: config, backbone, heads, language, attention, coords and decoding.
Inputs are made from a seed with numpy and given to both; weights go from
the JAX tree through `weights.state_dict_from_jax`."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dcnet_tpu.config as jcfg
import dcnet_tpu.models.darknet as jdk
from dcnet_tpu.eval.metrics import AverageMeter as JaxAverageMeter
from dcnet_tpu.eval.metrics import grounding_metrics as jax_grounding_metrics
from dcnet_tpu.models.attention import PhraseAttention as JaxPhraseAttention
from dcnet_tpu.models.heads import (
    ConvBNReLU as JaxConvBNReLU, DenseBNReLU as JaxDenseBNReLU,
    FusionFCN as JaxFusionFCN, MappingLang as JaxMappingLang,
    l2_normalize as jax_l2_normalize)
from dcnet_tpu.models.lstm import BiLSTMEncoder as JaxBiLSTM
from dcnet_tpu.ops import boxes as jboxes
from dcnet_tpu.ops import decode as jdecode
from dcnet_tpu.ops.coords import generate_coord as jax_generate_coord
import dcnet_tpu_torch.config as pcfg
import dcnet_tpu_torch.models.darknet as pdk
from dcnet_tpu_torch.eval.metrics import AverageMeter, grounding_metrics
from dcnet_tpu_torch.models.attention import PhraseAttention
from dcnet_tpu_torch.models.heads import (
    ConvBNReLU, DenseBNReLU, MappingLang, build_fusion_fcn, fusion_fcn,
    l2_normalize)
from dcnet_tpu_torch.models.lstm import BiLSTMEncoder
from dcnet_tpu_torch.ops import boxes as pboxes
from dcnet_tpu_torch.ops import decode as pdecode
from dcnet_tpu_torch.ops.coords import generate_coord
from dcnet_tpu_torch.weights import load_into, state_dict_from_jax
from tests.test_torch_slice import randomize_jax_variables

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _init(module, *args, seed=0, **kw):
    variables = module.init(jax.random.PRNGKey(seed), *args, **kw)
    return randomize_jax_variables(jax.device_get(variables), seed)


def _sub_sd(name, variables, prefix):
    """state_dict_from_jax of one module placed at `name` in the model tree,
    with the reference `prefix` stripped."""
    sd = state_dict_from_jax({name: variables["params"]},
                             {name: variables.get("batch_stats", {})})
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    assert out, f"no keys under {prefix}"
    return out


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


# ---- config ------------------------------------------------------------

@pytest.mark.parametrize("size", [64, 256, 416])
@pytest.mark.parametrize("dataset,legacy", [("VID", False), ("referit", False),
                                            ("referit", True), ("flickr", False)])
def test_config_derived_values(size, dataset, legacy):
    j = jcfg.DCNetConfig(image_size=size, dataset=dataset, legacy_anchor_typo=legacy)
    p = pcfg.DCNetConfig(image_size=size, dataset=dataset, legacy_anchor_typo=legacy)
    assert (p.strides, p.grids, p.all_positions) == \
        (j.strides, j.grids, j.all_positions)
    assert p.anchors_full == j.anchors_full
    assert p.scale_offsets() == j.scale_offsets()
    for s in range(3):
        assert p.scaled_anchors(s) == j.scaled_anchors(s)
    assert p.textdim == j.textdim


# ---- backbone ----------------------------------------------------------

@pytest.mark.parametrize("name", ["yolov3_layer_defs", "mini_backbone_defs"])
def test_layer_defs_equal(name):
    got = [dataclasses.asdict(d) for d in getattr(pdk, name)()]
    want = [dataclasses.asdict(d) for d in getattr(jdk, name)()]
    assert got == want


_POOL_CFG = """[net]
channels=3
[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky
[maxpool]
size=2
stride=2
[maxpool]
size=2
stride=1
[maxpool]
size=3
stride=2
[yoloconvolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky
[route]
layers=-2
[yoloconvolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=linear
[shortcut]
from=-2
[convolutional]
filters=8
size=1
stride=1
pad=1
activation=linear
[yoloconvolutional]
batch_normalize=1
filters=4
size=1
stride=1
pad=1
activation=leaky
"""


@pytest.mark.parametrize("defs_name,size", [("mini", 64), ("pool", 15)])
def test_backbone_maps_match_jax(tmp_path, defs_name, size):
    """Captured maps from the same `.weights` file through both readers;
    the `pool` cfg covers maxpool padding (odd input), routes, shortcuts,
    linear activations and conv biases."""
    if defs_name == "mini":
        jdefs, pdefs = jdk.mini_backbone_defs(), pdk.mini_backbone_defs()
    else:
        jdefs = jdk.parse_darknet_cfg(_POOL_CFG)[1]
        pdefs = pdk.parse_darknet_cfg(_POOL_CFG)[1]
        assert [dataclasses.asdict(d) for d in pdefs] == \
            [dataclasses.asdict(d) for d in jdefs]
    path = str(tmp_path / "w.weights")
    pdk.random_darknet_weights_file(pdefs, path, seed=7, scale=0.2)
    jvars, _ = jdk.load_darknet_weights(jdefs, path)
    sd, header = pdk.load_darknet_weights(pdefs, path)
    assert list(header) == [0, 2, 0, 0, 0]
    net = pdk.DarknetBackbone(pdefs, device="cpu")
    load_into(net, {k[len("visumodel."):]: v for k, v in sd.items()})
    x = np.random.RandomState(0).randn(2, size, size, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jdk.DarknetBackbone(layer_defs=jdefs).apply(jvars, jnp.asarray(x))
    got = net(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-4, atol=1e-4)


def test_upsample2_exact():
    x = np.random.RandomState(1).randn(2, 3, 5, 4).astype(np.float32)
    np.testing.assert_array_equal(pdk.upsample2(torch.from_numpy(x)).numpy(),
                                  np.asarray(jdk.upsample2(jnp.asarray(x))))


# ---- heads ----------------------------------------------------------------

def test_l2_normalize_clamps_squared_norm():
    x = np.random.RandomState(2).randn(3, 4, 8).astype(np.float32)
    x[1, 2] = 0.0  # an all-zero slice maps to zero
    for dim in (-1, 1):
        _close(l2_normalize(torch.from_numpy(x), dim=dim),
               jax_l2_normalize(jnp.asarray(x), axis=dim), atol=1e-6)
    assert not l2_normalize(torch.from_numpy(x))[1, 2].any()


@pytest.mark.parametrize("kernel,leaky", [(1, False), (3, False), (1, True)])
def test_conv_bn_relu_matches_jax(kernel, leaky):
    x = np.random.RandomState(3).randn(2, 6, 6, 12).astype(np.float32)
    jm = JaxConvBNReLU(16, kernel, leaky=leaky)
    v = _init(jm, jnp.asarray(x))
    pm = ConvBNReLU(12, 16, kernel, leaky=leaky, device="cpu")
    load_into(pm, _sub_sd("mapping_visu_0", v, "mapping_visu.0."))
    with jax.default_matmul_precision("highest"):
        _close(pm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)), atol=1e-4)


def _bf16(x):
    """x rounded to bf16 (held as float32), so both sides start equal."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _same_bf16_rounding(got, want):
    """bf16 outputs of the port and of JAX on the same inputs: within one
    bf16 step everywhere and equal but for rare flips from summation order
    (a different rounding rule, such as an unrounded leaky slope, moves
    about a tenth of the elements)."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got = got.detach().float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    assert np.mean(got != want) <= 0.02


@pytest.mark.parametrize("kernel,leaky", [(1, False), (3, False), (1, True)])
def test_conv_bn_relu_bf16_rounds_as_jax(kernel, leaky):
    """bf16 compute: conv in bf16, BN math in fp32 stored in bf16, then the
    activation in bf16, as the JAX package does."""
    x = _bf16(np.random.RandomState(3).randn(2, 6, 6, 12).astype(np.float32))
    jm = JaxConvBNReLU(16, kernel, leaky=leaky, dtype=jnp.bfloat16)
    v = _init(jm, jnp.asarray(x))
    pm = ConvBNReLU(12, 16, kernel, leaky=leaky, dtype=torch.bfloat16,
                    device="cpu")
    load_into(pm, _sub_sd("mapping_visu_0", v, "mapping_visu.0."))
    _same_bf16_rounding(pm(torch.from_numpy(x).bfloat16()),
                        jm.apply(v, jnp.asarray(x, jnp.bfloat16)))


def test_split_conv_bn_relu_matches_concat_and_jax():
    """corr_conv's split input (shared center half computed once) equals
    the per-reference concat conv, and the JAX split form."""
    rng = np.random.RandomState(4)
    shared = rng.randn(2, 4, 4, 8).astype(np.float32)
    parts = [rng.randn(2, 4, 4, 8).astype(np.float32) for _ in range(3)]
    jm = JaxConvBNReLU(10, 1)
    v = _init(jm, jnp.asarray(np.concatenate([shared, parts[0]], -1)))
    pm = ConvBNReLU(16, 10, 1, device="cpu")
    load_into(pm, _sub_sd("corr_conv_0", v, "corr_conv.0.0."))
    got = pm((torch.from_numpy(shared), [torch.from_numpy(p) for p in parts]))
    with jax.default_matmul_precision("highest"):
        want = jm.apply(v, (jnp.asarray(shared), [jnp.asarray(p) for p in parts]))
    for g, w, p in zip(got, want, parts):
        _close(g, w, atol=1e-5)
        concat = pm(torch.from_numpy(np.concatenate([shared, p], -1)))
        torch.testing.assert_close(g, concat, rtol=1e-5, atol=1e-5)


def test_dense_gram_factors_match_dense_gram_and_jax():
    """The rank-8 location branch: ce (ceᵀ (obj ∘ W)) equals the dense
    (P, P) Gram product, and the JAX gram_factors path."""
    rng = np.random.RandomState(5)
    b, p, e, c = 2, 21, 8, 12
    ce = rng.randn(b, p, e).astype(np.float32)
    obj = rng.randn(b, p).astype(np.float32)
    jm = JaxDenseBNReLU(c)
    v = _init(jm, jnp.zeros((1, p)))
    pm = DenseBNReLU(p, c, device="cpu")
    load_into(pm, _sub_sd("loc_text_embedding", v, "loc_text_embedding."))
    got = pm(None, gram_factors=(torch.from_numpy(ce), torch.from_numpy(obj)))
    gram = np.einsum("bpe,bqe->bpq", ce, ce) * obj[:, None, :]
    dense = pm(torch.from_numpy(gram.reshape(-1, p)))
    torch.testing.assert_close(got, dense, rtol=1e-4, atol=1e-4)
    with jax.default_matmul_precision("highest"):
        want = jm.apply(v, None, gram_factors=(jnp.asarray(ce), jnp.asarray(obj)))
    _close(got, want, atol=1e-5)


def test_dense_gram_factors_bf16_rounds_as_jax():
    rng = np.random.RandomState(5)
    ce = _bf16(rng.randn(2, 21, 8).astype(np.float32))
    obj = _bf16(rng.randn(2, 21).astype(np.float32))
    jm = JaxDenseBNReLU(12, dtype=jnp.bfloat16)
    v = _init(jm, jnp.zeros((1, 21)))
    pm = DenseBNReLU(21, 12, dtype=torch.bfloat16, device="cpu")
    load_into(pm, _sub_sd("loc_text_embedding", v, "loc_text_embedding."))
    got = pm(None, gram_factors=(torch.from_numpy(ce).bfloat16(),
                                 torch.from_numpy(obj).bfloat16()))
    want = jm.apply(v, None, gram_factors=(jnp.asarray(ce, jnp.bfloat16),
                                           jnp.asarray(obj, jnp.bfloat16)))
    _same_bf16_rounding(got, want)


def test_mapping_lang_matches_jax():
    x = np.random.RandomState(6).randn(3, 24).astype(np.float32)
    jm = JaxMappingLang(16)
    v = _init(jm, jnp.asarray(x))
    pm = MappingLang(24, 16, device="cpu")
    load_into(pm, _sub_sd("mapping_lang", v, "mapping_lang."))
    with jax.default_matmul_precision("highest"):
        _close(pm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("light", [False, True])
def test_fusion_fcn_matches_jax(light):
    x = np.random.RandomState(7).randn(2, 4, 4, 20).astype(np.float32)
    jm = JaxFusionFCN(16, light=light)
    v = _init(jm, jnp.asarray(x))
    emb, out = build_fusion_fcn(20, 16, light=light, device="cpu")
    sd = state_dict_from_jax({"fcn_0": v["params"]}, {"fcn_0": v["batch_stats"]},
                             light=light)
    load_into(emb, {k[len("fcn_emb.0."):]: a for k, a in sd.items()
                    if k.startswith("fcn_emb.0.")})
    load_into(out, {k[len("fcn_out.0."):]: a for k, a in sd.items()
                    if k.startswith("fcn_out.0.")})
    intmd, outbox = fusion_fcn(emb, out, torch.from_numpy(x), torch.float32)
    with jax.default_matmul_precision("highest"):
        jint, jbox = jm.apply(v, jnp.asarray(x))
    assert tuple(outbox.shape) == (2, 3, 5, 4, 4)
    _close(intmd, jint, atol=1e-4)
    _close(outbox, jbox, atol=1e-4)


# ---- language -------------------------------------------------------------

def _padded_ids():
    ids = np.random.RandomState(8).randint(1, 30, (4, 10)).astype(np.int32)
    ids[1, 6:] = 0   # padded
    ids[2, 1:] = 0   # one token
    ids[3, :] = 0    # empty: clamped to length 1
    return ids


def test_bilstm_matches_jax_on_padded_ids():
    ids = _padded_ids()
    jm = JaxBiLSTM(vocab_size=30, word_embedding_size=12, word_vec_size=12,
                   hidden_size=10)
    v = _init(jm, jnp.asarray(ids))
    pm = BiLSTMEncoder(30, 12, 12, 10, device="cpu").eval()  # no dropout
    load_into(pm, _sub_sd("textmodel", v, "textmodel."))
    got = pm(torch.from_numpy(ids))
    with jax.default_matmul_precision("highest"):
        want = jm.apply(v, jnp.asarray(ids))
    for g, w in zip(got, want):  # sent, context, embedded
        _close(g, w, atol=1e-5)


def test_phrase_attention_matches_jax():
    rng = np.random.RandomState(9)
    ids = _padded_ids()
    context = rng.randn(4, 10, 20).astype(np.float32)
    embedded = rng.randn(4, 10, 12).astype(np.float32)
    jm = JaxPhraseAttention()
    v = _init(jm, jnp.asarray(context), jnp.asarray(embedded), jnp.asarray(ids))
    pm = PhraseAttention(20, device="cpu")
    load_into(pm, _sub_sd("sub_attn", v, "sub_attn."))
    got = pm(torch.from_numpy(context), torch.from_numpy(embedded),
             torch.from_numpy(ids))
    want = jm.apply(v, jnp.asarray(context), jnp.asarray(embedded),
                    jnp.asarray(ids))
    for g, w in zip(got, want):  # attn, weighted
        _close(g, w, atol=1e-6)


# ---- coords, boxes, decoding -------------------------------------------

@pytest.mark.parametrize("h,w", [(4, 4), (3, 5), (8, 8)])
def test_generate_coord_exact(h, w):
    np.testing.assert_allclose(generate_coord(h, w).numpy(),
                               np.asarray(jax_generate_coord(h, w)),
                               rtol=0, atol=1e-7)


def test_box_utilities_match_jax():
    rng = np.random.RandomState(10)
    a = np.abs(rng.randn(6, 4)).astype(np.float32) * 20
    a[:, 2:] += a[:, :2]
    b = np.abs(rng.randn(6, 4)).astype(np.float32) * 20
    b[:, 2:] += b[:, :2]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _close(pboxes.xyxy2xywh(ta), jboxes.xyxy2xywh(jnp.asarray(a)), atol=1e-6)
    _close(pboxes.xywh2xyxy(ta), jboxes.xywh2xyxy(jnp.asarray(a)), atol=1e-6)
    _close(pboxes.bbox_iou(ta, tb), jboxes.bbox_iou(jnp.asarray(a), jnp.asarray(b)))
    _close(pboxes.bbox_iou(ta, tb, xyxy=False),
           jboxes.bbox_iou(jnp.asarray(a), jnp.asarray(b), xyxy=False))
    _close(pboxes.bbox_iou_pairwise(ta, tb),
           jboxes.bbox_iou_pairwise(jnp.asarray(a), jnp.asarray(b)))
    _close(pboxes.wh_iou(ta[:, 2:], tb[:, 2:]),
           jboxes.wh_iou(jnp.asarray(a[:, 2:]), jnp.asarray(b[:, 2:])))


def _outbox(seed, ties):
    cfg = jcfg.DCNetConfig(image_size=256)
    rng = np.random.RandomState(seed)
    ob = [rng.randn(3, 3, 5, g, g).astype(np.float32) for g in cfg.grids]
    if ties:  # equal maxima in two scales and inside one map: first wins
        for o in ob:
            o[:, :, 4] = np.round(o[:, :, 4])
        ob[0][0, 1, 4, 2, 3] = ob[2][0, 0, 4, 5, 5] = 9.0
        ob[1][1, 2, 4, 0, 1] = ob[1][1, 2, 4, 7, 1] = 9.0
    return ob


@pytest.mark.parametrize("ties", [False, True])
def test_decode_best_and_topk_match_jax(ties):
    ob = _outbox(11, ties)
    jc, pc = jcfg.DCNetConfig(image_size=256), pcfg.DCNetConfig(image_size=256)
    pob = [torch.from_numpy(o) for o in ob]
    job = [jnp.asarray(o) for o in ob]
    for got, want in ((pdecode.decode_best(pob, pc), jdecode.decode_best(job, jc)),
                      (pdecode.decode_topk(pob, 7, pc), jdecode.decode_topk(job, 7, jc))):
        for f in ("best_n", "scale", "gi", "gj"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), err_msg=f)
        _close(got.boxes, want.boxes, rtol=1e-5, atol=1e-4)
        _close(got.score, want.score, atol=0)
    _close(pdecode.flatten_conf(pob), jdecode.flatten_conf(job), atol=0)


def test_inverse_letterbox_matches_jax():
    rng = np.random.RandomState(12)
    boxes = (rng.rand(4, 1, 4) * 256).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2]
    ratio = rng.uniform(0.3, 1.0, (4, 1)).astype(np.float32)
    dw = rng.uniform(0, 40, (4, 1)).astype(np.float32)
    dh = rng.uniform(0, 40, (4, 1)).astype(np.float32)
    ow, oh = (256 - 2 * dw) / ratio, (256 - 2 * dh) / ratio
    got = pdecode.inverse_letterbox(torch.from_numpy(boxes), ratio, dw, dh, ow, oh)
    want = jdecode.inverse_letterbox(jnp.asarray(boxes), *(jnp.asarray(a) for a in
                                                           (ratio, dw, dh, ow, oh)))
    _close(got, want, atol=1e-4)


def test_grounding_metrics_match_jax():
    """acc@0.5, center accuracy and mIoU, and their running averages."""
    rng = np.random.RandomState(13)
    iou = rng.rand(16).astype(np.float32)
    cells = [rng.randint(0, 3, 16).astype(np.int32) for _ in range(6)]
    got = grounding_metrics(torch.from_numpy(iou),
                            *(torch.from_numpy(c) for c in cells))
    want = jax_grounding_metrics(jnp.asarray(iou), *(jnp.asarray(c) for c in cells))
    assert set(got) == set(want) == {"acc50", "acc_center", "miou"}
    for k in want:
        _close(got[k], want[k], atol=1e-7)
    meter, jmeter = AverageMeter(), JaxAverageMeter()
    for n, v in ((4, 0.5), (12, 0.25), (1, 1.0)):
        meter.update(v, n)
        jmeter.update(v, n)
    assert (meter.avg, meter.count, meter.sum) == (jmeter.avg, jmeter.count, jmeter.sum)
