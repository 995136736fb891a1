"""The precision choice of the port's tensor-core kernels, emulated on the
CPU: the fp32 co-attention block (K1, K2, K4's fp32 rings;
`csrc/attend_tf32.cuh`) and the backward K3 (`csrc/coattn_bwd.cu`) feed
fp32 operands to the tensor cores by 3xTF32 (`csrc/tf32x3.cuh`): each
operand x is split into big = tf32(x) (round to nearest) and small =
x - big, which the tensor cores read to TF32 by dropping its low bits, and
a product adds a_small b_big + a_big b_small + a_big b_big. An operand
that is exact in TF32 (a bf16 value) has no small part.

Here TF32 rounding is emulated in float64 (10 mantissa bits, round to
nearest, or truncated where the tensor cores read a value as it is), so
each product carries only its operands' rounding, and the
result is held against the float64 plain version at the limits the card's
checks use (`chip_smoke.py`: fp32 rtol 1e-4 / atol 1e-5 and relative l2
1e-4; K3 in bf16 one bf16 step + 1e-5, relative l2 1e-2). Shapes are the
main path's: B=1, P=1024, C=512, T=10, l2-normalised rows.
"""

import numpy as np
import pytest
import torch

from dcnet_tpu_torch.kernels import coattn

T = 10.0
P, C = 1024, 512
LIMITS = {torch.float32: dict(rtol=1e-4, atol=1e-5, rel=1e-4),
          torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5, rel=1e-2)}


def tf32(x: torch.Tensor, chop: bool = False) -> torch.Tensor:
    """float64 x rounded to TF32's 10 mantissa bits: to nearest, or (chop)
    toward zero, as the tensor cores read an fp32 register."""
    m, e = torch.frexp(x)
    m = torch.trunc(m * 2048.0) if chop else torch.round(m * 2048.0)
    return m * torch.pow(2.0, (e - 11).double())


def product(a, b, small_a: bool, small_b: bool) -> torch.Tensor:
    """a @ b as the kernels feed it to the tensor cores: the big parts
    (rounded to nearest), plus each small part that is asked for (3xTF32
    with both, one pass with neither), summed in float64."""
    big_a, big_b = tf32(a), tf32(b)
    out = big_a @ big_b
    if small_a:
        out = out + tf32(a - big_a, chop=True) @ big_b
    if small_b:
        out = out + big_a @ tf32(b - big_b, chop=True)
    return out


def fp32(x: torch.Tensor) -> torch.Tensor:
    """An fp32 value the kernel holds in registers, carried in float64."""
    return x.float().double()


def _rows(rng, *shape, dtype=torch.float32):
    """l2-normalised rows in `dtype`, carried in float64."""
    x = rng.randn(*shape)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return torch.from_numpy(x).to(dtype).double()


def _agreement(got, want, dtype):
    """(elementwise within rtol/atol, relative l2 error)."""
    lim = LIMITS[dtype]
    ok = bool(((got - want).abs() <= lim["atol"] + lim["rtol"] * want.abs()).all())
    return ok, ((got - want).norm() / want.norm()).item()


def attend_emulated(q, kv, three: bool) -> torch.Tensor:
    """The fp32 block's arithmetic: logits and PV on the tensor cores (three
    passes or one), the softmax weights fp32 and unrounded."""
    s = product(q, kv.transpose(-1, -2), three, three) * T
    w = fp32(torch.softmax(s, dim=-1))
    return product(w, kv, three, three)


@pytest.mark.parametrize("passes", [3, 1])
def test_fp32_block_needs_three_tf32_passes(passes):
    """3xTF32 meets the fp32 limits against the float64 plain version with
    room to spare (relative l2 about 1e-7); one TF32 pass misses the
    relative-l2 limit (about 3e-4), while its elementwise error still
    hides under atol 1e-5 against outputs of about 1.4e-3."""
    rng = np.random.RandomState(0)
    q, kv = _rows(rng, 1, P, C), _rows(rng, 1, P, C)
    want = coattn.attend_plain(q, kv, T)
    got = attend_emulated(q, kv, three=passes == 3)
    ok, rel = _agreement(got, want, torch.float32)
    if passes == 3:
        assert ok and rel <= 1e-6, rel
    else:
        assert ok and rel > LIMITS[torch.float32]["rel"], rel


def bwd_emulated(q, kv, g, dtype):
    """K3's arithmetic: S and dW with both operands split unless the inputs
    are bf16 (exact in TF32: one pass), dS kv, dSᵀ q and Wᵀ g with the fp32
    operand split and the input operand split unless bf16; W, dW, D and dS
    fp32; dq and dkv rounded once to the input dtype."""
    sm = dtype == torch.float32
    s = product(q, kv.transpose(-1, -2), sm, sm) * T
    w = fp32(torch.softmax(s, dim=-1))
    dw = fp32(product(g, kv.transpose(-1, -2), sm, sm))
    ds = fp32(w * (dw - (dw * w).sum(-1, keepdim=True)))
    dq = T * product(ds, kv, True, sm)
    dkv = (T * product(ds.transpose(-1, -2), q, True, sm)
           + product(w.transpose(-1, -2), g, True, sm))
    return dq.to(dtype).double(), dkv.to(dtype).double()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_passes_meet_the_backward_limits(dtype):
    """K3 with the passes it takes (three in fp32; in bf16 one for S and dW,
    two for the products with an fp32 operand) meets its limits against
    the float64 plain version rounded to the input dtype."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(1)
    q, kv = _rows(rng, 1, P, C, dtype=dt), _rows(rng, 1, P, C, dtype=dt)
    g = torch.from_numpy(rng.randn(1, P, C)).to(dt).double()
    want = coattn.attend_bwd_plain(q, kv, T, g)
    for got, w in zip(bwd_emulated(q, kv, g, dt), want):
        ok, rel = _agreement(got, w.to(dt).double(), dt)
        assert ok and rel <= LIMITS[dt]["rel"], rel


def test_tf32_rounding_leaves_every_bf16_value_unchanged():
    """Every finite bf16 value is exact in TF32 (8 mantissa bits of 10): the
    basis for one pass on bf16 x bf16 products and for no small part of a
    bf16 operand."""
    bits = torch.arange(0, 1 << 16, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).double()
    x = x[torch.isfinite(x)]
    assert x.numel() == (1 << 16) - 2 * 2 ** 7  # all but the infinities and NaNs
    assert torch.equal(tf32(x), x)


def test_tf32_emulation_keeps_ten_mantissa_bits():
    """tf32 keeps 1 + 2^-10, rounds 1 + 2^-12 to 1, and the split
    x = big + small, small read to TF32 toward zero, leaves at most 2^-21
    of x."""
    one = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, -3.0 * (1 + 2 ** -9)],
                       dtype=torch.float64)
    assert torch.equal(tf32(one), torch.tensor([1.0 + 2 ** -10, 1.0, -3.0 * (1 + 2 ** -9)],
                                               dtype=torch.float64))
    x = fp32(torch.from_numpy(np.random.RandomState(2).randn(4096)))
    big = tf32(x)
    small = tf32(x - big, chop=True)
    assert ((x - big).abs() <= 2 ** -11 * x.abs()).all()
    assert ((x - big - small).abs() <= 2 ** -21 * x.abs()).all()
    assert ((x - big).abs() / x.abs()).max() > 2 ** -14  # one part alone is coarse
