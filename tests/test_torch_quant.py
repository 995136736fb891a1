"""The port's int8 post-training quantization against the JAX package's
(`dcnet_tpu/ops/quant.py`, `QuantConv2D`, the int8 co-attention logits, the
serving engine's `quantize()`), on the CPU: mini defs at 64 px, the JAX
side jitted once per fixture.

What is bitwise and what is held at a limit, and why:
- the int8 convolution's int32 sums, and one convolution's epilogue
  (scale and bias as one fused multiply-add, leaky, fp32 / bf16 / int8
  out) on the same int8 input: bitwise, as XLA's CPU backend emits a lone
  conv's epilogue as an FMA;
- `quantize_backbone`: the int8 weights and 1/s_in bitwise; scale and bias
  within rtol 1e-6, because XLA's CPU `rsqrt` (in the folded BatchNorm) is
  faithfully, not correctly, rounded; with JAX's rsqrt values substituted,
  every array is bitwise;
- the int8 backbone given JAX's qparams: bf16 activations bitwise; fp32
  activations bitwise at the first capture, and elsewhere within atol 1e-6
  (outputs of order 1) with at least 90% of the elements bitwise: where a
  conv's output feeds an upsample + concat fusion, XLA's CPU code contracts
  the epilogue into an FMA in some lanes and not in others (found here:
  the mini defs' /16 and /8 captures, ~92% bitwise, 6e-8 apart at most);
- the int8 trunk (`trunk_quant="int8"`) with JAX's scales: rtol 1e-4 /
  atol 1e-4, decoded indices equal (the float parts of the trunk differ
  as in `tests/test_torch_slice.py`, and its BatchNorm takes XLA's rsqrt);
- calibration abs-max within rtol 1e-5 (float passes in other orders);
- the int8 logits: the integer sums bitwise, the attended features within
  rtol 1e-5 / atol 1e-6 (fp32 softmax);
- the quantized engine given JAX's qparams and trunk scales: boxes rtol
  1e-4 / atol 1e-3 px, scores rtol 1e-4 / atol 1e-5 (the slice's limits).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from jax import lax

from dcnet_tpu.config import DCNetConfig as JaxConfig
from dcnet_tpu.models import DCNet as JaxDCNet
from dcnet_tpu.models.darknet import LayerDef as JaxLayerDef
from dcnet_tpu.models.darknet import mini_backbone_defs as jax_mini_defs
from dcnet_tpu.models.darknet import yolov3_layer_defs as jax_yolov3_defs
from dcnet_tpu.models.dcnet import DCNet as JaxDCNetCls
from dcnet_tpu.ops import coattention as jax_coattention
from dcnet_tpu.ops import quant as JQ
from dcnet_tpu.ops.decode import decode_best as jax_decode_best
from dcnet_tpu.serving import engine as jax_engine
from dcnet_tpu_torch.kernels import conv_s8 as K6
from dcnet_tpu_torch.models.darknet import mini_backbone_defs, yolov3_layer_defs
from dcnet_tpu_torch.ops import coattention, quant
from dcnet_tpu_torch.ops.decode import decode_best
from dcnet_tpu_torch.serving import engine
from tests.test_torch_slice import SMALL, clip_inputs, jax_model, port_model

_DN = ("NHWC", "HWIO", "NHWC")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_qparams(jq):
    """JAX qparams in the port's layout ((Co, k, k, Ci) int8 on the CPU)."""
    return {i: {"w": torch.from_numpy(np.ascontiguousarray(
                    np.asarray(d["w"]).transpose(3, 0, 1, 2))),
                "inv_in": float(np.float32(d["inv_in"])),
                "scale": torch.tensor(np.asarray(d["scale"])),
                "bias": torch.tensor(np.asarray(d["bias"]))} for i, d in jq.items()}


@pytest.fixture(scope="module")
def setup():
    """The JAX mini model and the port's with its weights; calibration
    frames; JAX's act_max and qparams (fp32 and bf16-cast params)."""
    jcfg, jmodel, variables = jax_model()
    cfg, model = port_model(variables)
    rng = np.random.RandomState(5)
    images = rng.rand(6, 64, 64, 3).astype(np.float32)
    params = variables["params"]["visumodel"]
    stats = variables["batch_stats"]["visumodel"]
    jdefs = jax_mini_defs()
    cal = jax.jit(lambda p, im: JQ.calibrate(jdefs, p, stats, im))
    act_max = JQ.merge_calibration([cal(params, jnp.asarray(images))])
    jq = JQ.quantize_backbone(jdefs, params, stats, act_max)
    return dict(jcfg=jcfg, jmodel=jmodel, variables=variables, cfg=cfg,
                model=model, images=images, act_max=act_max, jq=jq)


# --- K6's plain version ------------------------------------------------------

@pytest.mark.parametrize("k,stride,ci,co", [
    (1, 1, 3, 8), (3, 1, 3, 255), (3, 2, 8, 8), (1, 2, 8, 255),
    (3, 1, 40, 8), (3, 2, 40, 255), (1, 1, 1032, 8), (3, 1, 1032, 255)])
def test_conv_s8_plain_equals_xla(k, stride, ci, co):
    rng = np.random.RandomState(ci + co)
    x = rng.randint(-127, 128, (2, 7, 9, ci)).astype(np.int8)
    w = rng.randint(-127, 128, (co, k, k, ci)).astype(np.int8)
    pad = (k - 1) // 2
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w.transpose(1, 2, 3, 0)), (stride, stride),
        [(pad, pad), (pad, pad)], dimension_numbers=_DN,
        preferred_element_type=jnp.int32)
    got = K6.conv_s8(torch.from_numpy(x), torch.from_numpy(w), stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("out", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("act", ["leaky", "linear"])
def test_one_conv_epilogue_equals_int8_conv_fn(out, act):
    """The epilogue (fma(acc, scale, bias), leaky, the output or the int8
    chain's requantization) equals JAX's `int8_conv_fn` bitwise."""
    rng = np.random.RandomState(1)
    ld = JaxLayerDef(type="convolutional", filters=255, size=3, stride=1, pad=1,
                     batch_normalize=True, activation=act, in_filters=40,
                     out_filters=255)
    x = rng.randint(-127, 128, (2, 12, 12, 40)).astype(np.int8)
    w = rng.randint(-127, 128, (3, 3, 40, 255)).astype(np.int8)
    scale = (rng.rand(255) * 1e-4).astype(np.float32)
    bias = rng.randn(255).astype(np.float32)
    qp = {"0": {"w": jnp.asarray(w), "inv_in": jnp.float32(1.0),
                "scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
          "1": {"inv_in": jnp.float32(3.7)}}
    jdt = jnp.float32 if out == "int8" else jnp.dtype(out)
    fn = JQ.int8_conv_fn(qp, jdt, out_quant={0: 1} if out == "int8" else None)
    want = np.asarray(jax.jit(lambda xx: fn(0, ld, xx))(jnp.asarray(x)).astype(
        jnp.int32 if out == "int8" else jnp.float32))
    got = K6.conv_s8(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(
        w.transpose(3, 0, 1, 2))), 1, 1, scale=torch.from_numpy(scale),
        bias=torch.from_numpy(bias), act="leaky" if act == "leaky" else None,
        out_dtype=getattr(torch, out), inv_out=float(np.float32(3.7)))
    assert got.dtype == getattr(torch, out)
    np.testing.assert_array_equal(got.to(torch.int32 if out == "int8" else torch.float32)
                                  .numpy(), want)


def test_fma32_rounds_once():
    """`fma32` equals XLA's fused `a * b + c` on random fp32 triples, and
    rounds a sum that float64 would put exactly on an fp32 midpoint the
    way the exact value says (two roundings would give 1.0 here)."""
    rng = np.random.RandomState(0)
    a = rng.randn(1 << 16).astype(np.float32)
    b = (rng.rand(1 << 16) * 1e-3).astype(np.float32)
    c = rng.randn(1 << 16).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    got = K6.fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    np.testing.assert_array_equal(got, want)
    a, b = np.float32(1 + 2.0 ** -23), np.float32(1 - 2.0 ** -24)
    c = np.float32(2.0 ** -47 * (1 + 2.0 ** -23))   # a*b + c = 1 + 2^-24 + 2^-70
    got = K6.fma32(*(torch.tensor([v]) for v in (a, b, c))).item()
    assert got == np.float32(1 + 2.0 ** -23)
    assert np.float32(np.float64(a) * np.float64(b) + np.float64(c)) == 1.0


# --- ops/quant.py -------------------------------------------------------------

def test_calibrate_matches_jax(setup):
    got = quant.merge_calibration([quant.calibrate(
        setup["model"].visumodel.layer_defs, setup["model"].visumodel,
        torch.from_numpy(setup["images"]))])
    want = setup["act_max"]
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * want[k], k


@pytest.mark.parametrize("params", ["float32", "bf16_cast"])
def test_quantize_backbone_matches_jax(setup, params, monkeypatch):
    """Weights and 1/s_in bitwise, scale and bias within rtol 1e-6 (XLA's
    rsqrt); with JAX's rsqrt substituted into the port's folded BN every
    array is bitwise."""
    variables = setup["variables"]
    _, model = port_model(variables)
    if params == "bf16_cast":
        variables = jax_engine.cast_params_for_serving(variables)
        engine.cast_params_for_serving(model)
    jdefs = jax_mini_defs()
    want = JQ.quantize_backbone(jdefs, variables["params"]["visumodel"],
                                variables["batch_stats"]["visumodel"], setup["act_max"])
    defs = model.visumodel.layer_defs

    def check(got, exact):
        assert set(got) == set(want)
        for i, d in want.items():
            np.testing.assert_array_equal(got[i]["w"].numpy(),
                                          np.asarray(d["w"]).transpose(3, 0, 1, 2))
            assert np.float32(got[i]["inv_in"]) == np.float32(d["inv_in"])
            for k in ("scale", "bias"):
                g, w = got[i][k].numpy(), np.asarray(d[k])
                assert g.dtype == w.dtype == np.float32
                if exact:
                    np.testing.assert_array_equal(g, w, err_msg=f"{i}/{k}")
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=f"{i}/{k}")

    check(quant.quantize_backbone(defs, model.visumodel, setup["act_max"]), exact=False)

    def fold_with_xla_rsqrt(backbone, i):
        bn = backbone.module_list[i][1]
        r = np.array(lax.rsqrt(jnp.asarray(bn.running_var.numpy()) + 1e-5))
        a = bn.weight.float() * torch.from_numpy(r)
        return a, bn.bias.float() - bn.running_mean.float() * a

    monkeypatch.setattr(quant, "_fold_bn", fold_with_xla_rsqrt)
    check(quant.quantize_backbone(defs, model.visumodel, setup["act_max"]), exact=True)


@pytest.mark.parametrize("defs", ["mini", "yolov3"])
def test_sole_conv_consumer_matches_jax(defs):
    port_defs, jax_defs = {"mini": (mini_backbone_defs, jax_mini_defs),
                           "yolov3": (yolov3_layer_defs, jax_yolov3_defs)}[defs]
    assert quant.sole_conv_consumer(port_defs()) == JQ.sole_conv_consumer(jax_defs())
    assert quant.sole_conv_consumer(port_defs())


def test_live_layers_drop_only_what_no_capture_reads():
    """The pruned traversal skips exactly the layers after each capture
    that nothing reads (YOLOv3: the 3x3 and the detection conv of each
    head, and the last capture's own conv), and gives the unpruned
    captures."""
    defs = yolov3_layer_defs()
    dead = sorted(set(range(len(defs))) - quant.live_layers(defs))
    assert [defs[i].type for i in dead] == (["convolutional", "convolutional", "yolo"] * 2
                                            + ["yoloconvolutional", "convolutional",
                                               "convolutional", "yolo"])

    def conv(i, ld, t):  # any function with the conv's output shape
        t = t[:, ::ld.stride, ::ld.stride]
        return (t.mean(-1, keepdim=True) + i).expand(*t.shape[:3], ld.filters)

    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    pruned = quant.traverse(mini_backbone_defs(), x, conv)
    full = quant.traverse(mini_backbone_defs(), x, conv, prune=False)
    assert all(torch.equal(a, b) for a, b in zip(pruned, full))


@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_backbone_int8_matches_jax(setup, act, chain):
    """Given JAX's qparams: bf16 activations bitwise; fp32 bitwise at the
    first capture, within 2 units in the last place elsewhere (module
    doc), with and without the int8 chain."""
    jq, images = setup["jq"], setup["images"]
    want = jax.jit(lambda im: JQ.backbone_apply_int8(
        jax_mini_defs(), jq, im, act_dtype=jnp.dtype(act), int8_chain=chain))(
        jnp.asarray(images))
    got = quant.backbone_apply_int8(setup["model"].visumodel.layer_defs,
                                    _port_qparams(jq), torch.from_numpy(images),
                                    act_dtype=getattr(torch, act), int8_chain=chain)
    for s, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == getattr(torch, act)
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        if act == "bfloat16" or s == 0:
            np.testing.assert_array_equal(g, w, err_msg=f"capture {s}")
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f"capture {s}")
            assert (g == w).mean() >= 0.9, (s, (g == w).mean())


def test_quant_extract_features_matches_jax(setup):
    """The int8 backbone + the float mapping head, JAX's qparams."""
    jq, images = setup["jq"], setup["images"]
    want = jax.jit(lambda im: JQ.quant_extract_features(
        setup["jmodel"], setup["variables"], jq, im))(jnp.asarray(images))
    got = quant.quant_extract_features(setup["model"], _port_qparams(jq),
                                       torch.from_numpy(images))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


# --- the int8 trunk -----------------------------------------------------------

@pytest.fixture(scope="module")
def trunk(setup):
    """JAX's trunk calibration over one eval_clip, its int8 eval_clip with
    those scales; the port's calibration of the same pass."""
    images, ids = clip_inputs()
    jmodel, variables = setup["jmodel"], setup["variables"]

    def calib(m, v):
        return jax.jit(lambda vv, x, w: m.apply(
            vv, x, w, n_frame=5, method=JaxDCNetCls.eval_clip, mutable=["quant"]))(
            v, jnp.asarray(images), jnp.asarray(ids))

    col = JQ.calibrate_trunk(jmodel, variables, calib)
    qmodel = JQ.trunk_quant_variant(jmodel, "int8")
    with jax.default_matmul_precision("highest"):
        jout = jax.jit(lambda v, x, w: qmodel.apply(
            v, x, w, n_frame=5, method=JaxDCNetCls.eval_clip))(
            {**variables, "quant": col}, jnp.asarray(images), jnp.asarray(ids))
    _, model = port_model(variables)
    scales = quant.calibrate_trunk(model, lambda m: m.eval_clip(
        torch.from_numpy(images), torch.from_numpy(ids)))
    return dict(col=col, jout=jout, scales=scales, images=images, ids=ids)


def test_trunk_calibration_matches_jax(trunk):
    want = {"/".join(k): float(v) for k, v in flatten_dict(trunk["col"]).items()}
    got = trunk["scales"]
    assert set(got) == set(want) and len(got) == 18
    for k in want:
        assert abs(float(got[k]) - want[k]) <= 1e-5 * want[k], k


def test_trunk_int8_eval_clip_matches_jax(setup, trunk, monkeypatch):
    """trunk_quant="int8" with JAX's scales: rtol 1e-4 / atol 1e-4, the
    decoded indices equal; K6 runs every trunk conv."""
    from dcnet_tpu_torch.models import heads
    _, model = port_model(setup["variables"], trunk_quant="int8")
    quant.set_trunk_scales(model, {"/".join(k): np.asarray(v)
                                   for k, v in flatten_dict(trunk["col"]).items()})
    calls = []
    monkeypatch.setattr(heads, "conv_s8", lambda *a, **k: calls.append(1) or K6.conv_s8(*a, **k))
    out = model.eval_clip(torch.from_numpy(trunk["images"]), torch.from_numpy(trunk["ids"]))
    jout = trunk["jout"]
    for field in ("outbox", "sim_score", "loc_score", "corr_feat", "only_obj"):
        for s in range(3):
            np.testing.assert_allclose(getattr(out, field)[s].numpy(),
                                       np.asarray(getattr(jout, field)[s]),
                                       rtol=1e-4, atol=1e-4, err_msg=f"{field}[{s}]")
    dec, jdec = decode_best(out.outbox, setup["cfg"]), jax_decode_best(jout.outbox, setup["jcfg"])
    for f in ("best_n", "scale", "gi", "gj"):
        np.testing.assert_array_equal(getattr(dec, f).numpy(), np.asarray(getattr(jdec, f)))
    assert len(calls) == 3 + 3 * 5 + 3 * 4   # mapping, corr_conv (1 + 4 refs), fcn


def test_trunk_int8_stacked_split_equals_list_split(setup, trunk):
    """coattn_batch_refs runs corr_conv on the stacked (B, R, ...) split
    input as one K6 launch a scale; its int32 sums are those of the list
    form, so the two runs are equal."""
    outs = []
    for batch in (False, True):
        _, model = port_model(setup["variables"], trunk_quant="int8",
                              coattn_batch_refs=batch)
        quant.set_trunk_scales(model, trunk["scales"])
        outs.append(model.eval_clip(torch.from_numpy(trunk["images"]),
                                    torch.from_numpy(trunk["ids"])))
    for a, b in zip(outs[0].corr_feat, outs[1].corr_feat):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("change", ["weight_in_place", "load_state_dict", "act_max",
                                    "bn_statistics"])
def test_trunk_int8_constants_follow_their_sources(change):
    """ConvBNReLU's int8 constants are made once and reused while the
    weights, BatchNorm statistics and act_max stay; after any of them
    changes the output equals a fresh module's on the new state, bitwise,
    in both input forms (plain and split)."""
    from dcnet_tpu_torch.models.heads import ConvBNReLU
    gen = torch.Generator().manual_seed(5)

    def make():
        m = ConvBNReLU(24, 8, 1, quant="int8")
        m.bn.running_mean.normal_(generator=gen)
        m.bn.running_var.uniform_(0.5, 2.0, generator=gen)
        m.act_max.fill_(3.0)
        return m

    m = make()
    x = torch.randn(2, 5, 5, 24, generator=gen)
    split = (x[..., :16], [x[..., 16:], torch.randn(2, 5, 5, 8, generator=gen)])
    first = m(x)
    consts = m._int8_cache[2]
    assert torch.equal(m(x), first) and m._int8_cache[2] is consts
    with torch.no_grad():
        if change == "weight_in_place":
            m.conv.weight.mul_(-1.5)
        elif change == "load_state_dict":
            m.load_state_dict({k: v + 0.25 if k == "conv.weight" else v
                               for k, v in m.state_dict().items()})
        elif change == "act_max":
            m.act_max.fill_(1.0)
        else:
            m.bn.running_mean.add_(0.5)
    fresh = make()
    fresh.load_state_dict(m.state_dict())
    fresh.act_max.copy_(m.act_max)
    got = m(x)
    assert m._int8_cache[2] is not consts
    assert torch.equal(got, fresh(x)) and not torch.equal(got, first)
    for a, b in zip(m(split), fresh(split)):
        assert torch.equal(a, b)


# --- int8 co-attention logits and batched references --------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_logits_and_batched_match_jax(dtype):
    rng = np.random.RandomState(2)
    cen = rng.randn(2, 4, 4, 24).astype(np.float32)
    refs = rng.randn(2, 3, 4, 4, 24).astype(np.float32)
    cen /= np.linalg.norm(cen, axis=-1, keepdims=True)
    refs /= np.linalg.norm(refs, axis=-1, keepdims=True)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jc, jr = jnp.asarray(cen).astype(jdt), jnp.asarray(refs).astype(jdt)
    tc, tr = torch.from_numpy(cen).to(tdt), torch.from_numpy(refs).to(tdt)
    # the integer sums, then dequantised: bitwise in fp32
    want = jax_coattention._int8_logits(jc.reshape(2, 16, 24), jr[:, 0].reshape(2, 16, 24),
                                        "bpc,bqc->bpq", 10.0)
    got = coattention._int8_logits(tc.reshape(2, 16, 24), tr[:, 0].reshape(2, 16, 24),
                                   "bpc,bqc->bpq", 10.0)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    with jax.default_matmul_precision("highest"):
        for int8 in (False, True):
            jb = jax_coattention.coattention_center_batched(jc, jr, 10.0, int8_logits=int8)
            pb = coattention.coattention_center_batched(tc, tr, 10.0, int8_logits=int8)
            np.testing.assert_allclose(pb.float().numpy(), np.asarray(jb.astype(jnp.float32)),
                                       **tol)
            j1 = jax_coattention.coattention_center(jc, jr[:, 1], 10.0, int8_logits=int8)
            p1 = coattention.coattention_center(tc, tr[:, 1], 10.0, int8_logits=int8)
            np.testing.assert_allclose(p1.float().numpy(), np.asarray(j1.astype(jnp.float32)),
                                       **tol)
            torch.testing.assert_close(pb[:, 1].float(), p1.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("over", [dict(coattn_int8_logits=True),
                                  dict(coattn_batch_refs=True),
                                  dict(coattn_batch_refs=True, coattn_int8_logits=True)],
                         ids=["int8_logits", "batch_refs", "both"])
def test_coattn_variants_eval_clip_match_jax(setup, over, monkeypatch):
    images, ids = clip_inputs()
    jmodel = JaxDCNet(cfg=JaxConfig(**SMALL, **over), backbone_defs=jax_mini_defs())
    with jax.default_matmul_precision("highest"):
        jout = jax.jit(lambda v, x, w: jmodel.apply(
            v, x, w, n_frame=5, method=JaxDCNetCls.eval_clip))(
            setup["variables"], jnp.asarray(images), jnp.asarray(ids))
    _, model = port_model(setup["variables"], **over)
    import dcnet_tpu_torch.models.dcnet as port_dcnet
    k1 = []
    monkeypatch.setattr(port_dcnet, "coattention_center_fused",
                        lambda *a, **k: k1.append(1))
    out = model.eval_clip(torch.from_numpy(images), torch.from_numpy(ids))
    assert not k1   # the einsum path, as in JAX
    for s in range(3):
        np.testing.assert_allclose(out.outbox[s].numpy(), np.asarray(jout.outbox[s]),
                                   rtol=1e-4, atol=1e-4)


# --- the engine and the files -------------------------------------------------

def test_engine_quantize_matches_jax(setup, trunk):
    """The quantized GroundingEngine at 2 streams x 3 ticks (int8 chain,
    fp32, float rings, K1 path) against the JAX engine, both given JAX's
    qparams and trunk scales; the port's own quantize() gives JAX's int8
    weights on the same calibration frames and switches the trunk."""
    variables, jq = setup["variables"], setup["jq"]
    rng = np.random.RandomState(9)
    frames = rng.rand(3, 2, 64, 64, 3).astype(np.float32)
    ids = rng.randint(1, 50, (2, 20)).astype(np.int32)
    jcfg = JaxConfig(**SMALL)
    jm = JaxDCNet(cfg=jcfg, backbone_defs=jax_mini_defs())
    jeng = jax_engine.GroundingEngine(jm, variables, jcfg, n_streams=2, donate_state=False,
                                      int8_chain=True)
    jeng.qparams, jeng.trunk_qcol = jq, trunk["col"]
    jeng._qmodel = JQ.trunk_quant_variant(jm, "int8")
    jeng._step = jeng._jit_step()
    with jax.default_matmul_precision("highest"):
        jstate, jouts = jeng.init_state(ids), []
        for t in range(3):
            jstate, *o = jeng.step(jstate, frames[t])
            jouts.append([np.asarray(x) for x in o])
    _, model = port_model(variables)
    peng = engine.GroundingEngine(model, n_streams=2, int8_chain=True)
    peng.qparams = _port_qparams(jq)
    quant.set_trunk_scales(model, {"/".join(k): np.asarray(v)
                                   for k, v in flatten_dict(trunk["col"]).items()})
    quant.trunk_quant_variant(model, "int8")
    pstate = peng.init_state(torch.from_numpy(ids))
    for t in range(3):
        pstate, *o = peng.step(pstate, torch.from_numpy(frames[t]))
        for name, g, w in zip(("fused", "raw", "score"), o, jouts[t]):
            tol = dict(rtol=1e-4, atol=1e-5) if name == "score" else dict(rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(g.numpy(), w, **tol, err_msg=f"{name}, tick {t}")
    own = engine.GroundingEngine(port_model(variables)[1], n_streams=2).quantize(
        setup["images"], ids)
    for i, d in jq.items():
        np.testing.assert_array_equal(own.qparams[i]["w"].numpy(),
                                      np.asarray(d["w"]).transpose(3, 0, 1, 2))
    assert own.model.cfg.trunk_quant == "int8"
    assert set(own.trunk_scales) == set(trunk["scales"])
    assert all(float(v) > 0 for v in own.trunk_scales.values())


def test_files_cross_packages(setup, trunk, tmp_path):
    """qparams and trunk-scale .npz files written by either package read
    back equal in the other."""
    jq = setup["jq"]
    JQ.save_qparams(str(tmp_path / "jax_q.npz"), jq)
    got = quant.load_qparams(str(tmp_path / "jax_q.npz"))
    mine = quant.quantize_backbone(setup["model"].visumodel.layer_defs,
                                   setup["model"].visumodel, setup["act_max"])
    quant.save_qparams(str(tmp_path / "port_q.npz"), mine)
    back = JQ.load_qparams(str(tmp_path / "port_q.npz"))
    for i, d in jq.items():
        np.testing.assert_array_equal(got[i]["w"].numpy(), np.asarray(d["w"]).transpose(3, 0, 1, 2))
        assert got[i]["inv_in"] == float(np.float32(d["inv_in"]))
        for k in ("scale", "bias"):
            np.testing.assert_array_equal(got[i][k].numpy(), np.asarray(d[k]))
            np.testing.assert_array_equal(np.asarray(back[i][k]), mine[i][k].numpy())
        np.testing.assert_array_equal(np.asarray(back[i]["w"]),
                                      mine[i]["w"].numpy().transpose(1, 2, 3, 0))
        assert back[i]["w"].dtype == jnp.int8 and back[i]["inv_in"].dtype == jnp.float32
    JQ.save_trunk_scales(str(tmp_path / "jax_t.npz"), trunk["col"])
    quant.save_trunk_scales(str(tmp_path / "port_t.npz"), trunk["scales"])
    got_t = quant.load_trunk_scales(str(tmp_path / "jax_t.npz"))
    back_t = flatten_dict(JQ.load_trunk_scales(str(tmp_path / "port_t.npz")))
    want_t = {"/".join(k): np.asarray(v) for k, v in flatten_dict(trunk["col"]).items()}
    assert set(got_t) == set(want_t)
    for k, v in want_t.items():
        assert got_t[k] == v
        assert np.asarray(back_t[tuple(k.split("/"))]) == trunk["scales"][k]
    _, model = port_model(setup["variables"])
    quant.set_trunk_scales(model, got_t)
    assert all(quant.trunk_scales(model)[k] == got_t[k] for k in got_t)
    assert set(unflatten_dict(back_t)) == {k[0] for k in back_t}
