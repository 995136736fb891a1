"""K2 (the pair) and K3 (the backward) in the port: their plain versions
against the JAX package's Pallas kernels in interpret mode (forward and
`jax.vjp` gradients, a P=512 case with two 256-row TPU tiles, bf16 inputs),
the einsum pair, and the autograd wiring. The CUDA kernels themselves run
only on the card (`tests/test_torch_cuda.py`).

fp32 tolerance rtol 1e-5 / atol 1e-6: the same arithmetic summed in another
order. The upstream gradients have scale 0.1, so the gradients are ~0.1 and
atol 1e-6 is 1e-5 of their scale (at P=512 fp32 summation order alone moves
elements near zero by ~5e-7 of it). bf16: one bf16 step of the output (2^-7
relative), since both sides compute in fp32 and round once at the end.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcnet_tpu.ops.coattention import coattention_pair as jax_pair_einsum
from dcnet_tpu.ops.pallas.coattn import _attend_bwd as jax_attend_bwd
from dcnet_tpu.ops.pallas.coattn import coattention_fused as jax_fused
from dcnet_tpu.ops.pallas.coattn import coattention_one as jax_one
from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.kernels import coattn
from dcnet_tpu_torch.ops.coattention import coattention_pair

SHAPES = [(2, 16, 8), (1, 512, 8)]  # one TPU tile; two 256-row tiles
TOL = dict(rtol=1e-5, atol=1e-6)


def _arrays(seed, b, p, c, n=4, scale=0.3):
    """Two inputs of scale `scale`, then upstream gradients of scale 0.1."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, p, c) * (scale if i < 2 else 0.1)).astype(np.float32)
            for i in range(n)]


def _t(*xs, grad=False):
    return [torch.from_numpy(x).requires_grad_(grad) for x in xs]


@pytest.mark.parametrize("b,p,c", SHAPES)
def test_pair_forward_matches_pallas_interpret(b, p, c):
    f1, f2, _, _ = _arrays(p, b, p, c)
    w1, w2 = jax_fused(jnp.asarray(f1), jnp.asarray(f2), 10.0, True)
    o1, o2 = coattn.coattention_fused(*_t(f1, f2), 10.0)
    np.testing.assert_allclose(o1.detach().numpy(), np.asarray(w1), **TOL)
    np.testing.assert_allclose(o2.detach().numpy(), np.asarray(w2), **TOL)


@pytest.mark.parametrize("b,p,c", SHAPES)
def test_pair_vjp_matches_pallas_interpret(b, p, c):
    """K2's backward (2 x K3, df1 = dq1 + dkv2, df2 = dkv1 + dq2) against
    jax.vjp of the Pallas custom_vjp, dkv accumulated across TPU row tiles
    at P=512."""
    f1, f2, g1, g2 = _arrays(p + 1, b, p, c)
    _, vjp = jax.vjp(lambda x, y: jax_fused(x, y, 10.0, True),
                     jnp.asarray(f1), jnp.asarray(f2))
    want = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    a, bb = _t(f1, f2, grad=True)
    o1, o2 = coattn.coattention_fused(a, bb, 10.0)
    torch.autograd.backward((o1, o2), _t(g1, g2))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(bb.grad.numpy(), np.asarray(want[1]), **TOL)


@pytest.mark.parametrize("b,p,c", SHAPES)
def test_one_vjp_matches_pallas_interpret(b, p, c):
    """K1 forward + K3 backward (the k>2 ring path) against jax.vjp of the
    single-direction custom_vjp."""
    q, kv, g, _ = _arrays(p + 2, b, p, c)
    out, vjp = jax.vjp(lambda x, y: jax_one(x, y, 10.0, True),
                       jnp.asarray(q), jnp.asarray(kv))
    want = vjp(jnp.asarray(g))
    a, bb = _t(q, kv, grad=True)
    got = coattn.coattention_one(a, bb, 10.0)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(bb.grad.numpy(), np.asarray(want[1]), **TOL)


@pytest.mark.parametrize("b,p,c", SHAPES + [(2, 169, 16)])
def test_bwd_plain_matches_pallas_kernel(b, p, c):
    """attend_bwd (plain on the CPU) against `_attend_bwd` itself; the
    ragged P=169 runs as one TPU tile of 169 rows."""
    q, kv, g, _ = _arrays(p + 3, b, p, c)
    want = jax_attend_bwd(jnp.asarray(q), jnp.asarray(kv), 10.0,
                          jnp.asarray(g), interpret=True)
    got = coattn.attend_bwd(*_t(q, kv), 10.0, torch.from_numpy(g))
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), **TOL)


def test_bwd_plain_bf16_matches_pallas_kernel():
    """bf16 inputs: fp32 math on the upcast inputs with the unrounded W,
    outputs rounded once to bf16, as the TPU kernel does: equal within one
    bf16 step, and equal outright but for rare rounding flips."""
    q, kv, g, _ = _arrays(7, 2, 16, 16)
    qb, kb, gb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, kv, g))
    want = jax_attend_bwd(qb, kb, 10.0, gb, interpret=True)
    got = coattn.attend_bwd(*(torch.from_numpy(x).bfloat16() for x in (q, kv)),
                            10.0, torch.from_numpy(g).bfloat16())
    for x, w in zip(got, want):
        assert x.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        x = x.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(x, w, rtol=2 ** -7, atol=1e-6)
        assert np.mean(x != w) <= 0.02


@pytest.mark.parametrize("c", [24, 1056])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_and_bwd_plain_match_pallas_at_any_width(c, dtype):
    """K2 forward and K3 at widths off every configured path (the card's
    general block and general backward pass): C = 24 and C = 1056, against
    the Pallas kernels in interpret mode. fp32 at the fp32 limits; bf16
    within one bf16 step of the output plus 1e-6 (each side rounds fp32
    values once)."""
    f1, f2, g1, _ = _arrays(c, 2, 32, c, scale=1.0 / np.sqrt(c))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = [jnp.asarray(x).astype(jd) for x in (f1, f2, g1)]
    t = [torch.from_numpy(x).to(td) for x in (f1, f2, g1)]
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-6)
    want = list(jax_fused(j[0], j[1], 10.0, True))
    want += list(jax_attend_bwd(j[0], j[1], 10.0, j[2], interpret=True))
    with torch.no_grad():
        got = list(coattn.coattention_fused(t[0], t[1], 10.0))
    got += list(coattn.attend_bwd(t[0], t[1], 10.0, t[2]))
    for x, w in zip(got, want):
        assert x.dtype == td and x.shape == (2, 32, c)
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)), **tol)


def test_bf16_backward_is_not_the_autograd_of_the_rounded_forward():
    """The backward uses the unrounded fp32 softmax: in bf16 it differs from
    autograd through `attend_plain` (whose weights are rounded to bf16),
    which is why K3 has a plain version of its own."""
    q, kv, g, _ = _arrays(8, 2, 64, 16)
    qb, kb = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, kv))
    coattn.attend_plain(qb, kb, 10.0).backward(torch.from_numpy(g).bfloat16())
    dq, dkv = coattn.attend_bwd_plain(qb.detach(), kb.detach(), 10.0,
                                      torch.from_numpy(g).bfloat16())
    assert not torch.equal(dkv, kb.grad)
    qf, kf = (torch.from_numpy(x).bfloat16().float().requires_grad_() for x in (q, kv))
    ref = torch.softmax(qf @ kf.transpose(1, 2) * 10.0, -1) @ kf
    ref.backward(torch.from_numpy(g).bfloat16().float())
    np.testing.assert_allclose(dq.float().numpy(), qf.grad.numpy(), rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("b,p,c", SHAPES)
def test_einsum_pair_matches_jax_and_the_pair_kernel(b, p, c):
    f1, f2, _, _ = _arrays(p + 4, b, p, c)
    h = 4 if p == 16 else 16
    x1, x2 = f1.reshape(b, h, p // h, c), f2.reshape(b, h, p // h, c)
    want = jax_pair_einsum(jnp.asarray(x1), jnp.asarray(x2), 10.0)
    got = coattention_pair(*_t(x1, x2), 10.0)
    fused = coattn.coattention_pair_fused(*_t(x1, x2), 10.0)
    for g, f, w in zip(got, fused, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(f.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_gradient_of_a_sliced_output_takes_strided_rows():
    """The k=2 path concatenates each attended map behind its frame, so the
    upstream gradient arrives as a slice of a concat (rows not contiguous):
    the backward takes it, and the kernels' row check would get a copy."""
    f1, f2, g1, _ = _arrays(9, 2, 16, 8)
    a, bb = _t(f1, f2, grad=True)
    o1, o2 = coattn.coattention_pair_fused(a.reshape(2, 4, 4, 8),
                                           bb.reshape(2, 4, 4, 8), 10.0)
    cat = torch.cat([a.reshape(2, 4, 4, 8), o1], dim=-1)
    (cat * torch.from_numpy(np.concatenate([g1, g1], -1)).reshape(2, 4, 4, 16)
     ).sum().backward()
    assert torch.isfinite(a.grad).all() and bb.grad.abs().sum() > 0
    g = torch.zeros(2, 16, 16)[..., 8:]
    assert coattn._rows_contiguous(g).is_contiguous()
    frame = torch.zeros(2, 2, 16, 8)[:, 1]  # batch-strided, rows contiguous
    assert coattn._rows_contiguous(frame) is frame


def test_cpu_training_never_counts_a_launch():
    kernels.reset_launches()
    f1, f2, g1, g2 = _arrays(10, 2, 16, 8)
    a, bb = _t(f1, f2, grad=True)
    o1, o2 = coattn.coattention_fused(a, bb, 10.0)
    torch.autograd.backward((o1, o2), _t(g1, g2))
    coattn.coattention_one(a, bb, 10.0).sum().backward()
    assert set(kernels.LAUNCHES.values()) == {0}


def test_backward_refuses_tensors_off_the_cpu_and_the_card():
    q = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        coattn.attend_bwd(q, q, 10.0, q.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattention_fused(q, q.to("meta"), 10.0)
