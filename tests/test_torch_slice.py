"""The port's eval slice against the JAX package: mini-defs
`eval_clip -> decode_best` at 64 px, 2 clips x 5 frames, same weights.

JAX is randomly initialised with randomised BN statistics and biases; the
port gets the converted weights (`weights.state_dict_from_jax`). Both run in
fp32 on the CPU. Tolerance rtol 1e-4 / atol 1e-4: XLA's and torch's CPU
convolutions sum in different orders.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcnet_tpu.config import DCNetConfig as JaxConfig
from dcnet_tpu.models import DCNet as JaxDCNet
from dcnet_tpu.models.darknet import mini_backbone_defs as jax_mini_defs
from dcnet_tpu.models.dcnet import DCNet as JaxDCNetCls
from dcnet_tpu.ops.decode import decode_best as jax_decode_best
from dcnet_tpu.ops.pallas.coattn import (
    coattention_center_fused as jax_coattention_center_fused)
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.models.darknet import mini_backbone_defs
from dcnet_tpu_torch.models.dcnet import DCNet
from dcnet_tpu_torch.ops.decode import decode_best
from dcnet_tpu_torch.weights import load_into, state_dict_from_jax

SMALL = dict(image_size=64, corpus_size=50, emb_size=64, lstm_hidden=64,
             word_embedding_size=64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def randomize_jax_variables(variables, seed=0):
    """Randomise BN statistics, BN scales and every bias of a flax init, so
    the conversion of each leaf kind is exercised."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x)
        name = getattr(path[-1], "key", "")
        parent = getattr(path[-2], "key", "") if len(path) > 1 else ""
        if name == "mean":
            return rng.normal(0, 0.3, x.shape).astype(x.dtype)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        if name == "scale" and parent.startswith("bn"):
            return (1 + 0.1 * rng.randn(*x.shape)).astype(x.dtype)
        if name == "bias":
            return (0.05 * rng.randn(*x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def jax_model(light=False, seed=0, **overrides):
    """(JAX config, JAX DCNet on mini defs, randomised numpy variables)."""
    cfg = JaxConfig(**{**SMALL, "light": light, **overrides})
    model = JaxDCNet(cfg=cfg, backbone_defs=jax_mini_defs())
    rng = np.random.RandomState(seed)
    images = jnp.asarray(rng.rand(2, 64, 64, 3).astype(np.float32))
    ids = jnp.asarray(rng.randint(1, 50, (2, 20)).astype(np.int32))
    init = jax.jit(lambda rngs, x, w: model.init(rngs, x, w, train=False))
    variables = init(
        {"params": jax.random.PRNGKey(seed), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, images, ids)
    return cfg, model, randomize_jax_variables(jax.device_get(variables), seed)


def jax_eval_clip(model, variables, images, ids, n_frame=5):
    """The JAX package's eval_clip, jitted (one XLA program compiles far
    faster on the CPU than op-by-op dispatch)."""
    fn = jax.jit(lambda v, x, w: model.apply(v, x, w, n_frame=n_frame,
                                             method=JaxDCNetCls.eval_clip))
    with jax.default_matmul_precision("highest"):
        return fn(variables, jnp.asarray(images), jnp.asarray(ids))


def port_model(variables, light=False, **overrides):
    """The port's mini-defs DCNet on the CPU with the JAX weights loaded."""
    cfg = DCNetConfig(**{**SMALL, "light": light, **overrides})
    model = DCNet(cfg, backbone_defs=mini_backbone_defs(), device="cpu")
    load_into(model, state_dict_from_jax(
        variables["params"], variables["batch_stats"], light=light))
    return cfg, model


def clip_inputs(seed=1, clips=2, n_frame=5):
    rng = np.random.RandomState(seed)
    images = rng.rand(clips * n_frame, 64, 64, 3).astype(np.float32)
    ids = rng.randint(1, 50, (clips, 20)).astype(np.int32)
    ids[1, 9:] = 0  # a padded phrase
    return images, ids


@pytest.fixture(scope="module")
def pair():
    jcfg, jmodel, variables = jax_model()
    cfg, model = port_model(variables)
    images, ids = clip_inputs()
    jout = jax_eval_clip(jmodel, variables, images, ids)
    out = model.eval_clip(torch.from_numpy(images), torch.from_numpy(ids))
    return jcfg, jmodel, variables, cfg, model, jout, out, images, ids


@pytest.mark.parametrize("field", ["outbox", "sim_score", "loc_score",
                                   "corr_feat", "only_obj"])
def test_eval_clip_matches_jax(pair, field):
    *_, jout, out, _, _ = pair
    for s in range(3):
        np.testing.assert_allclose(
            getattr(out, field)[s].numpy(), np.asarray(getattr(jout, field)[s]),
            rtol=1e-4, atol=1e-4, err_msg=f"{field}[{s}]")


def test_decode_best_boxes_equal(pair):
    jcfg, _, _, cfg, _, jout, out, _, _ = pair
    jdec = jax_decode_best(jout.outbox, jcfg)
    dec = decode_best(out.outbox, cfg)
    for f in ("best_n", "scale", "gi", "gj"):
        np.testing.assert_array_equal(getattr(dec, f).numpy(),
                                      np.asarray(getattr(jdec, f)), err_msg=f)
    np.testing.assert_allclose(dec.boxes.numpy(), np.asarray(jdec.boxes),
                               rtol=1e-4, atol=1e-3)


def test_eval_features_with_cached_language(pair):
    """eval_features over extract_features + encode_language == eval_clip."""
    *_, model, _, out, images, ids = pair
    feats = model.extract_features(torch.from_numpy(images))
    per_frame = [f.reshape(2, 5, *f.shape[1:]) for f in feats]
    lang = model.encode_language(torch.from_numpy(ids))
    again = model.eval_features(per_frame, torch.from_numpy(ids),
                                language=lang)
    for a, b in zip(again.outbox, out.outbox):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_no_split_corr_conv_matches_jax(pair):
    """split_corr_conv=False (per-reference concat conv) against JAX."""
    _, _, variables, _, _, _, _, images, ids = pair
    jcfg = JaxConfig(**SMALL, split_corr_conv=False)
    jmodel = JaxDCNet(cfg=jcfg, backbone_defs=jax_mini_defs())
    _, model = port_model(variables, split_corr_conv=False)
    jout = jax_eval_clip(jmodel, variables, images, ids)
    out = model.eval_clip(torch.from_numpy(images), torch.from_numpy(ids))
    for s in range(3):
        np.testing.assert_allclose(out.outbox[s].numpy(),
                                   np.asarray(jout.outbox[s]),
                                   rtol=1e-4, atol=1e-4)


def test_light_variant_matches_jax():
    jcfg, jmodel, variables = jax_model(light=True, seed=3)
    _, model = port_model(variables, light=True)
    images, ids = clip_inputs(seed=4)
    jout = jax_eval_clip(jmodel, variables, images, ids)
    out = model.eval_clip(torch.from_numpy(images), torch.from_numpy(ids))
    for s in range(3):
        np.testing.assert_allclose(out.outbox[s].numpy(),
                                   np.asarray(jout.outbox[s]),
                                   rtol=1e-4, atol=1e-4)


def test_bfloat16_eval_clip_runs(pair):
    """The bf16 compute path: outputs stored in bf16, finite, and the
    modulated conf close to fp32's."""
    *_, cfg, model, _, out, images, ids = pair
    bf = DCNet(cfg.replace(compute_dtype="bfloat16"),
               backbone_defs=mini_backbone_defs(), device="cpu")
    bf.load_state_dict(model.state_dict())
    got = bf.eval_clip(torch.from_numpy(images), torch.from_numpy(ids))
    for g, r in zip(got.outbox, out.outbox):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        assert (g.float() - r).abs().max() < 0.25


def _rel_gap(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_bfloat16_eval_clip_matches_jax(pair, monkeypatch):
    """The bf16 compute path against the JAX package's bf16 path
    (`DCNet(dtype=bfloat16)`) on the same weights and clips. JAX's
    co-attention goes through its Pallas kernel in interpret mode, as its
    eval path does on a TPU (on the CPU it would take the einsum form,
    whose logits are bf16). bf16 rounding depends on operation order, so
    neither side is exact and the min-max normalised loc_score amplifies
    it: each output of the port must lie at most twice as far (relative
    l2) from the fp32 JAX result as the JAX package's own bf16 output does,
    plus 1e-3, and the decoded boxes must be equal."""
    jcfg, _, variables, _, _, jout32, _, images, ids = pair
    monkeypatch.setattr(
        JaxDCNetCls, "_coattn_center",
        lambda self, f1, f2: jax_coattention_center_fused(
            f1, f2, self.cfg.coattn_temperature, interpret=True))
    jmodel = JaxDCNet(cfg=JaxConfig(**SMALL, compute_dtype="bfloat16"),
                      dtype=jnp.bfloat16, backbone_defs=jax_mini_defs())
    jout = jax_eval_clip(jmodel, variables, images, ids)
    cfg, model = port_model(variables, compute_dtype="bfloat16")
    out = model.eval_clip(torch.from_numpy(images), torch.from_numpy(ids))
    for field in ("outbox", "sim_score", "loc_score", "corr_feat", "only_obj"):
        for s in range(3):
            got, jbf = getattr(out, field)[s], getattr(jout, field)[s]
            assert got.dtype == torch.bfloat16 and jbf.dtype == jnp.bfloat16
            ref = getattr(jout32, field)[s]
            port_gap, jax_gap = _rel_gap(got, ref), _rel_gap(jbf, ref)
            assert port_gap <= 2 * jax_gap + 1e-3, (field, s, port_gap, jax_gap)
    jdec = jax_decode_best(jout.outbox, jcfg)
    dec = decode_best(out.outbox, cfg)
    for f in ("best_n", "scale", "gi", "gj"):
        np.testing.assert_array_equal(getattr(dec, f).numpy(),
                                      np.asarray(getattr(jdec, f)), err_msg=f)


@pytest.mark.parametrize("option", [
    dict(use_lstm=False, bert_model="bert-mini"), dict(trunk_quant="int8"),
    dict(coattn_batch_refs=True), dict(coattn_int8_logits=True)])
def test_unported_options_raise(option):
    """The BERT encoder, the int8 trunk and the co-attention variants are
    ported (held against JAX in tests/test_torch_bert.py and
    tests/test_torch_quant.py): the model builds and its eval_clip gives
    finite outputs."""
    cfg = DCNetConfig(**SMALL, **option)
    model = DCNet(cfg, backbone_defs=mini_backbone_defs(), device="cpu")
    images, ids = clip_inputs()
    out = model.eval_clip(torch.from_numpy(images), torch.from_numpy(ids))
    assert all(torch.isfinite(ob).all() for ob in out.outbox)


@pytest.mark.parametrize("option", [
    "int8_chain", "quantize", "mesh", "compiler_options"])
def test_unported_engine_options_raise(option):
    """XLA compiler options are not carried; the int8 backbone
    (`int8_chain`, `quantize()`) is ported and serves, and so is the
    engine's mesh: on a mesh of one process it serves every stream, as the
    plain engine does (two processes: tests/test_torch_mesh.py)."""
    from dcnet_tpu_torch.parallel import mesh
    from dcnet_tpu_torch.serving.engine import GroundingEngine
    model = DCNet(DCNetConfig(**SMALL), backbone_defs=mini_backbone_defs(),
                  device="cpu")
    kw = {"int8_chain": dict(int8_chain=True), "quantize": {},
          "mesh": dict(mesh=mesh.Mesh(n_data=1, n_model=1, data_rank=0)),
          "compiler_options": dict(compiler_options={"opt": "1"})}[option]
    if option == "mesh":
        rng = np.random.RandomState(1)
        frames = rng.rand(2, 64, 64, 3).astype(np.float32)
        ids = torch.ones((2, 20), dtype=torch.long)
        outs = []
        for eng in (GroundingEngine(model, n_streams=2, **kw),
                    GroundingEngine(model, n_streams=2)):
            outs.append(eng.step(eng.init_state(ids), frames)[1:])
        assert all(torch.equal(a, b) for a, b in zip(*outs))
        return
    if option in ("int8_chain", "quantize"):
        rng = np.random.RandomState(0)
        eng = GroundingEngine(model, n_streams=2, **kw).quantize(
            rng.rand(5, 64, 64, 3).astype(np.float32))
        state = eng.init_state(torch.ones((2, 20), dtype=torch.long))
        state, fused, raw, score = eng.step(state, rng.rand(2, 64, 64, 3).astype(np.float32))
        assert torch.isfinite(fused).all() and eng.qparams is not None
        return
    match = {"compiler_options": "XLA options have no PyTorch counterpart"}[option]
    with pytest.raises(NotImplementedError, match=match):
        GroundingEngine(model, n_streams=2, **kw)
