"""K5's plain version (`kernels.locgram.loc_gram_plain`, the CPU branch of
`fused_loc_gram`) against the JAX package's Pallas kernel in interpret mode,
as `tests/test_pallas_locgram.py` runs it; the port's `fold_dense_bn`
against JAX's on a mini-defs model's converted weights; and the plain K5
with those folded weights against both packages' rank-8 route,
`DenseBNReLU(None, gram_factors=...)` in eval mode, which is what the
model computes.

Tolerances. Against the Pallas kernel, the tests' own: rtol 1e-4 / atol
1e-5 at P=84, rtol 1e-3 / atol 1e-3 at P=1344 (the kernel's row tiling,
C=64). `fold_dense_bn`: rtol 1e-6 / atol 1e-7, one fp32 rounding of each
side's product and sum. Against the rank-8 route: the same function summed
in another order (P-term Gram rows against E-term factors, then P-term
sums either way), rtol 1e-4 / atol 1e-5 on outputs of order 0.1-1.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dcnet_tpu.models.heads import DenseBNReLU as JaxDenseBNReLU
from dcnet_tpu.ops.pallas.locgram import fold_dense_bn as jax_fold_dense_bn
from dcnet_tpu.ops.pallas.locgram import fused_loc_gram as jax_fused_loc_gram
from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.kernels import locgram
from tests.test_torch_slice import jax_model, port_model


def _inputs(seed, b, p, e, c, w_scale):
    rng = np.random.RandomState(seed)
    ce = rng.randn(b, p, e).astype(np.float32)
    ce /= np.linalg.norm(ce, axis=2, keepdims=True)
    obj = rng.randn(b, p).astype(np.float32)
    w = (rng.randn(p, c) * w_scale).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    return ce, obj, w, bias


@pytest.mark.parametrize("b,p,c,w_scale,tol", [
    (2, 84, 16, 0.1, dict(rtol=1e-4, atol=1e-5)),      # P = all_positions at 64 px
    (1, 1344, 64, 0.05, dict(rtol=1e-3, atol=1e-3)),   # 256 px: row-tiled Pallas grid
])
def test_plain_matches_pallas_kernel(b, p, c, w_scale, tol):
    ce, obj, w, bias = _inputs(0, b, p, 8, c, w_scale)
    want = np.asarray(jax_fused_loc_gram(jnp.asarray(ce), jnp.asarray(obj),
                                         jnp.asarray(w), jnp.asarray(bias),
                                         interpret=True))
    kernels.reset_launches()
    got = locgram.fused_loc_gram(*(torch.from_numpy(x) for x in (ce, obj, w, bias)))
    assert got.shape == (b, p, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **tol)
    assert kernels.LAUNCHES["loc_gram"] == 0  # CPU tensors launch nothing


def test_plain_keeps_ce_dtype_and_sums_in_fp32():
    """A bf16 ce gives a bf16 output of the fp32 Gram and product of the
    bf16 values, as the TPU kernel's `preferred_element_type` and
    `astype(out_ref.dtype)` do."""
    ce, obj, w, bias = _inputs(1, 2, 84, 8, 16, 0.1)
    ce16 = torch.from_numpy(ce).bfloat16()
    args = [torch.from_numpy(x) for x in (obj, w, bias)]
    got = locgram.fused_loc_gram(ce16, *args)
    want = locgram.loc_gram_plain(ce16.float(), *args).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def mini():
    """A mini-defs JAX model's randomised variables and the port's model
    with them loaded (randomised BN statistics, scales and biases)."""
    _, _, variables = jax_model()
    _, model = port_model(variables)
    return variables, model


def test_fold_dense_bn_matches_jax(mini):
    variables, model = mini
    want_w, want_b = jax_fold_dense_bn(variables["params"]["loc_text_embedding"],
                                       variables["batch_stats"]["loc_text_embedding"])
    w, b = locgram.fold_dense_bn(model.loc_text_embedding)
    assert w.shape == (model.cfg.all_positions, model.cfg.emb_size)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(b.numpy(), np.asarray(want_b),
                               rtol=1e-6, atol=1e-7)


def _gram_factors(model, seed, b=2):
    """ce and obj as `_trunk` hands them to the location branch: unit rows
    of E=8 and an l2-normalised objectness map over all positions."""
    rng = np.random.RandomState(seed)
    p = model.cfg.all_positions
    ce = rng.randn(b, p, 8).astype(np.float32)
    ce /= np.linalg.norm(ce, axis=2, keepdims=True)
    obj = np.abs(rng.randn(b, p)).astype(np.float32)
    obj /= np.linalg.norm(obj, axis=1, keepdims=True)
    return ce, obj


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_with_folded_weights_is_the_rank8_route(mini, seed):
    variables, model = mini
    ce, obj = _gram_factors(model, seed)
    w, b = locgram.fold_dense_bn(model.loc_text_embedding)
    got = locgram.fused_loc_gram(torch.from_numpy(ce), torch.from_numpy(obj), w, b)
    with torch.no_grad():
        port = model.loc_text_embedding(
            None, gram_factors=(torch.from_numpy(ce), torch.from_numpy(obj)),
            train=False).reshape(got.shape)
    jax_mod = JaxDenseBNReLU(features=model.cfg.emb_size)
    jax_vars = {"params": variables["params"]["loc_text_embedding"],
                "batch_stats": variables["batch_stats"]["loc_text_embedding"]}
    jax_out = np.asarray(jax_mod.apply(
        jax_vars, None, train=False,
        gram_factors=(jnp.asarray(ce), jnp.asarray(obj)))).reshape(got.shape)
    assert (got > 0).any() and (got == 0).any()  # the ReLU is active both ways
    torch.testing.assert_close(got, port, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=1e-4, atol=1e-5)
