"""K1 (co-attention) in the port: its plain version against the JAX
package's Pallas kernel (interpret mode) and einsum composition, and the
wrapper's dispatch rules. The CUDA kernel itself runs only on the card
(`tests/test_torch_cuda.py`)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dcnet_tpu.ops.coattention import coattention_center as jax_center
from dcnet_tpu.ops.pallas.coattn import coattention_center_fused as jax_center_fused
from dcnet_tpu.ops.pallas.coattn import coattention_one as jax_one
from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.kernels import coattn
from dcnet_tpu_torch.ops.coattention import coattention_center

SHAPES = [(2, 16, 8), (1, 512, 8)]  # one tile; several 256-row TPU tiles


def _pair(b, p, c, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, p, c).astype(np.float32) * scale,
            rng.randn(b, p, c).astype(np.float32) * scale)


@pytest.mark.parametrize("b,p,c", SHAPES + [(2, 169, 16)])
def test_plain_matches_pallas_interpret(b, p, c):
    q, kv = _pair(b, p, c, seed=p)
    want = np.asarray(jax_one(jnp.asarray(q), jnp.asarray(kv), 10.0, True))
    got = coattn.coattention_one(torch.from_numpy(q), torch.from_numpy(kv), 10.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,p,c", SHAPES)
def test_nhwc_wrapper_matches_einsum_center(b, p, c):
    q, kv = _pair(b, p, c, seed=p + 1)
    h = 4 if p == 16 else 16
    x1, x2 = q.reshape(b, h, p // h, c), kv.reshape(b, h, p // h, c)
    want = np.asarray(jax_center(jnp.asarray(x1), jnp.asarray(x2), 10.0))
    fused = coattn.coattention_center_fused(torch.from_numpy(x1),
                                            torch.from_numpy(x2), 10.0)
    plain = coattention_center(torch.from_numpy(x1), torch.from_numpy(x2), 10.0)
    np.testing.assert_allclose(fused.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        fused.numpy(),
        np.asarray(jax_center_fused(jnp.asarray(x1), jnp.asarray(x2), 10.0,
                                    interpret=True)),
        rtol=1e-5, atol=1e-6)


def test_plain_bf16_dtype_rules_match_pallas():
    """bf16 inputs: fp32 logits/softmax, bf16 weights into the PV product,
    bf16 out, as the TPU kernel. Within one bf16 step (2^-7 relative)
    everywhere and equal but for rare summation-order flips; bf16 logits,
    for one, would move the outputs by about 1%."""
    q, kv = _pair(2, 16, 16, seed=5)
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    kb = jnp.asarray(kv).astype(jnp.bfloat16)
    want = np.asarray(jax_one(qb, kb, 10.0, True).astype(jnp.float32))
    got = coattn.coattention_one(torch.from_numpy(q).bfloat16(),
                                 torch.from_numpy(kv).bfloat16(), 10.0)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    assert np.mean(got != want) <= 0.02


@pytest.mark.parametrize("c", [24, 1056])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_at_any_width(c, dtype):
    """Widths off every configured path: C = 24 (not a multiple of 16) and
    C = 1056 (past every tensor-core block), which the card runs on the
    general block. fp32 at the fp32 limits; bf16 within one bf16 step of the
    output plus 1e-6 (both sides round the same fp32 values)."""
    q, kv = _pair(2, 32, c, seed=c)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    kv /= np.linalg.norm(kv, axis=-1, keepdims=True)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_one(jnp.asarray(q).astype(jd), jnp.asarray(kv).astype(jd),
                              10.0, True).astype(jnp.float32))
    got = coattn.coattention_one(torch.from_numpy(q).to(td),
                                 torch.from_numpy(kv).to(td), 10.0)
    assert got.dtype == td and got.shape == (2, 32, c)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_strided_batch_input():
    """A frame sliced out of a (B, n, P, C) clip (batch stride n*P*C) gives
    the same result as its contiguous copy."""
    rng = np.random.RandomState(6)
    clip = torch.from_numpy(rng.randn(2, 5, 16, 8).astype(np.float32))
    got = coattn.coattention_one(clip[:, 2], clip[:, 0], 10.0)
    want = coattn.coattention_one(clip[:, 2].contiguous(),
                                  clip[:, 0].contiguous(), 10.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_wrapper_never_counts_a_launch():
    kernels.reset_launches()
    q, kv = _pair(2, 16, 8, seed=7)
    coattn.coattention_one(torch.from_numpy(q), torch.from_numpy(kv), 10.0)
    coattn.coattention_center_fused(torch.from_numpy(q).reshape(2, 4, 4, 8),
                                    torch.from_numpy(kv).reshape(2, 4, 4, 8))
    assert set(kernels.LAUNCHES.values()) == {0}


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor off the CPU that is not on one CUDA device is refused: the
    wrapper launches the kernel or raises, it does not fall back."""
    q = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattention_one(q, q.to("meta"), 10.0)
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattention_one(q.to("meta"), q.to("meta"), 10.0)



@pytest.mark.parametrize("dtype,c,body", [
    ("bfloat16", 512, "wgmma"), ("bfloat16", 256, "wgmma"), ("bfloat16", 128, "wgmma"),
    ("bfloat16", 384, "wgmma"), ("bfloat16", 80, "block"), ("bfloat16", 64, "block"),
    ("bfloat16", 640, "block"), ("float32", 512, "tf32x3"), ("int8", 512, "wgmma_s8"),
    ("float32", 16, "tf32x3"), ("float32", 80, "tf32x3"), ("float32", 256, "tf32x3"),
    ("float32", 528, "wide"), ("int8", 128, "wgmma_s8"), ("int8", 384, "wgmma_s8"),
    ("int8", 24, "wide"), ("int8", 64, "wide"), ("int8", 1056, "wide"),
    ("float32", 24, "wide"), ("float32", 1024, "wide"), ("bfloat16", 24, "wide"),
    ("bfloat16", 672, "block"), ("bfloat16", 688, "wide"), ("bfloat16", 1024, "wide")])
def test_block_is_chosen_by_shape(dtype, c, body):
    """K1, K2 and K4 launch the wgmma block for bf16 with C % 128 == 0 and
    C <= 512 (every configuration the repository runs), the 3xTF32 block
    for fp32 with C % 16 == 0 and C <= 512, the wgmma s8 block for int8
    rings with C % 128 == 0 and C <= 512, the WMMA block for other bf16
    widths its shared memory holds (C % 16 == 0, C <= 672), and the general
    block at every other width: a rule of dtype and width alone."""
    assert coattn.attend_body(getattr(torch, dtype), c) == body


@pytest.mark.parametrize("c,body", [(16, "tf32x3"), (512, "tf32x3"), (24, "wide"),
                                    (528, "wide"), (1024, "wide")])
def test_backward_pass_is_chosen_by_width(c, body):
    """K3 takes its 3xTF32 passes at C % 16 == 0, C <= 512, and its general
    pass at every other width, in either dtype."""
    assert coattn.attend_bwd_body(c) == body
