"""K4's plain version (`kernels.coattn.ring_attend_plain`, the CPU branch of
`coattention_ring_fused`) against the JAX package's ring kernel
`coattention_ring` run in interpret mode, as `tests/test_pallas_coattn.py`
runs it, on the same numpy rings.

Tolerances: fp32 rtol 1e-5 / atol 1e-6 (both sum fp32 products, in other
orders). bf16 and int8 outputs are bf16: the two sides round the same fp32
values, which may differ by fp32 summation order, so an element may be one
bf16 step apart (rtol 2^-7) plus 1e-6 near zero.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dcnet_tpu.ops.pallas.coattn import coattention_ring as jax_coattention_ring
from dcnet_tpu_torch.kernels import coattn

T = 10.0
BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)


def _ring(seed, b, s, h, w, c, scale=0.3):
    return (np.random.RandomState(seed).randn(b, s, h, w, c) * scale).astype(np.float32)


def _normalized_int8(seed, b, s, h, w, c):
    """int8 rings as the serving engine makes them: l2-normalised rows
    quantised with the static scale 1/127."""
    f = np.random.RandomState(seed).randn(b, s, h, w, c).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    return np.clip(np.round(f * 127.0), -127, 127).astype(np.int8)


def _jax(ring, center_t, slot, dtype=None):
    x = jnp.asarray(ring) if dtype is None else jnp.asarray(ring, dtype)
    return np.asarray(jax_coattention_ring(x, T, center_t, newest_slot=slot,
                                           interpret=True), np.float32)


def _port(ring, center_t, slot, dtype=None):
    x = torch.from_numpy(ring)
    if dtype is not None:
        x = x.to(dtype)
    out = coattn.coattention_ring_fused(x, T, center_t=center_t, newest_slot=slot)
    return out


@pytest.mark.parametrize("slot", [None, 0, 2, 4])
def test_fp32_ring_matches_jax_at_every_slot(slot):
    ring = _ring(5, 2, 5, 4, 4, 16)
    got = _port(ring, 2, slot)
    assert got.shape == (2, 4, 4, 4, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax(ring, 2, slot),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("slot", [None, 3])
def test_bf16_ring_matches_jax(slot):
    ring = _ring(6, 2, 5, 4, 4, 32)
    got = _port(ring, 2, slot, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               _jax(ring, 2, slot, jnp.bfloat16), **BF16_TOL)


@pytest.mark.parametrize("slot", [None, 1])
def test_int8_ring_matches_jax(slot):
    """int8 logits, dequantised kv, bf16 weights and output: the JAX kernel's
    int8 body on the same ring."""
    ring = _normalized_int8(7, 2, 5, 4, 4, 64)
    got = _port(ring, 2, slot)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _jax(ring, 2, slot),
                               **BF16_TOL)


def test_multi_tile_ring_matches_jax():
    """P = 512: the JAX kernel streams two row tiles of the center."""
    ring = _ring(8, 1, 3, 32, 16, 8, scale=0.2)
    got = _port(ring, 1, None)
    np.testing.assert_allclose(got.numpy(), _jax(ring, 1, None),
                               rtol=1e-5, atol=1e-6)


def test_ring_is_k1_per_reference():
    """Each reference's slice of K4's plain version is K1's plain version on
    the physical frames the slot picks (temporal frame j in slot
    (slot + 1 + j) mod S), in each float dtype."""
    ring = torch.from_numpy(_ring(9, 2, 5, 4, 4, 16)).reshape(2, 5, 16, 16)
    for dtype in (torch.float32, torch.bfloat16):
        x = ring.to(dtype)
        out = coattn.ring_attend_plain(x, T, 1, newest_slot=3)
        for r, j in enumerate([0, 2, 3, 4]):
            want = coattn.attend_plain(x[:, (4 + 1) % 5], x[:, (4 + j) % 5], T)
            torch.testing.assert_close(out[:, r], want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,c", [("float32", 24), ("bfloat16", 24), ("int8", 24),
                                     ("float32", 1056), ("bfloat16", 1056)])
def test_ring_matches_jax_at_any_width(dtype, c):
    """Widths off every configured path (the card's general block): C = 24
    and C = 1056, each ring dtype, at a rotated slot."""
    if dtype == "int8":
        ring = _normalized_int8(11, 1, 3, 4, 4, c)
        got = _port(ring, 1, 0)
        want = _jax(ring, 1, 0)
    else:
        ring = _ring(11, 1, 3, 4, 4, c, scale=1.0 / np.sqrt(c))
        jd = None if dtype == "float32" else jnp.bfloat16
        got = _port(ring, 1, 0, None if jd is None else torch.bfloat16)
        want = _jax(ring, 1, 0, jd)
    assert got.shape == (1, 2, 4, 4, c)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_int8_ring_matches_jax_past_1040():
    """int8 rings at C = 1056, past the width where every int32 logit
    (|logit| <= 127² C) is an integer fp32 holds exactly: the plain version
    sums the integer products exactly and rounds once to fp32, as the TPU
    body's int32 sums and astype do, and refuses no width."""
    ring = _normalized_int8(12, 1, 3, 4, 4, 1056)
    got = _port(ring, 1, None)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _jax(ring, 1, None), **BF16_TOL)


@pytest.mark.parametrize("slot,center", [(5, 2), (-1, 2), (0, 5)])
def test_slot_and_center_must_lie_in_the_ring(slot, center):
    with pytest.raises(ValueError, match="must lie in"):
        coattn.ring_attend_plain(torch.zeros(1, 5, 4, 16), T, center, slot)
