"""The CUDA kernels on the card (K1, the pair K2, the backward K3, the ring
kernel K4 and the location Gram K5), against their plain PyTorch versions,
the launches of one train step and of serving ticks, and train-mode
BatchNorm's card branch against its CPU branch.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Without a CUDA card every test here skips: the kernels are CUDA C++ with no
CPU mode (their plain versions are held against the JAX package in
`tests/test_torch_coattn.py`, `tests/test_torch_train_kernels.py`,
`tests/test_torch_ring.py` and `tests/test_torch_locgram.py`).
"""

import copy

import pytest
import torch

from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.kernels import coattn, locgram

pytestmark = pytest.mark.cuda
# On l2-normalised rows (C=512) an output element is about 0.044/sqrt(P),
# 1.4e-3 at P=1024: the bf16 limit is one bf16 step of the output (2^-7
# relative) plus 2e-4, well under the outputs themselves.
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=2e-4)}
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # ||got-want||/||want||
# K3 computes in fp32 whatever the input dtype and rounds once at the end, as
# its plain version does: in bf16 the two may differ by one bf16 step of the
# output (2^-7 relative) where fp32 summation order tips the rounding, plus
# fp32 noise near zero.
BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
           torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}


def _rel(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel is CUDA C++ with no "
                    "CPU mode")
    return torch.device("cuda", 0)


def _rows(gen, *shape):
    """l2-normalised rows, like the mapped features on the main path."""
    return torch.nn.functional.normalize(torch.randn(*shape, generator=gen), dim=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(card, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    for p in (64, 169, 256, 1024):
        q = _rows(gen, 8, p, 512).to(card, dt)
        kv = _rows(gen, 8, p, 512).to(card, dt)
        got = coattn.coattention_one(q, kv, 10.0)
        want = coattn.attend_plain(q, kv, 10.0)
        torch.cuda.synchronize()
        assert got.dtype == dt and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), **TOL[dt])
        assert _rel(got, want) <= REL_TOL[dt]
        # the limits are tight enough to reject zeros and a dropped T
        assert _rel(coattn.attend_plain(q, kv, 1.0), want) > REL_TOL[dt]
        assert _rel(torch.zeros_like(want), want) > REL_TOL[dt]


def test_kernel_takes_frames_sliced_from_a_clip(card):
    """The main path hands K1 frames of a (B, n, h, w, C) clip: batch-strided
    NHWC views. The NHWC wrapper gives what the plain version gives."""
    gen = torch.Generator().manual_seed(1)
    clip = _rows(gen, 4, 5, 13, 13, 64).to(card)
    got = coattn.coattention_center_fused(clip[:, 2], clip[:, 0], 10.0)
    want = coattn.attend_plain(clip[:, 2].reshape(4, 169, 64),
                               clip[:, 0].reshape(4, 169, 64), 10.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.reshape(4, 169, 64), want, **TOL[torch.float32])


def test_each_launch_counts_once(card):
    q = _rows(torch.Generator().manual_seed(2), 2, 64, 32).to(card)
    kernels.reset_launches()
    coattn.coattention_one(q, q, 10.0)
    coattn.coattention_center_fused(q.reshape(2, 8, 8, 32), q.reshape(2, 8, 8, 32))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["coattn_attend"] == 2


def _bwd_inputs(gen, b, p, c, dt, card):
    return (_rows(gen, b, p, c).to(card, dt), _rows(gen, b, p, c).to(card, dt),
            torch.randn(b, p, c, generator=gen).to(card, dt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_kernel_matches_plain_on_card(card, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3)
    for p in (64, 169, 256, 1024):
        q, kv, g = _bwd_inputs(gen, 4, p, 512, dt, card)
        got = coattn.attend_bwd(q, kv, 10.0, g)
        want = coattn.attend_bwd_plain(q, kv, 10.0, g)
        wrong_t = coattn.attend_bwd_plain(q, kv, 1.0, g)
        torch.cuda.synchronize()
        for a, w, bad in zip(got, want, wrong_t):
            assert a.dtype == dt and a.shape == q.shape
            torch.testing.assert_close(a.float(), w.float(), **BWD_TOL[dt])
            assert _rel(a, w) <= REL_TOL[dt]
            assert _rel(bad, w) > REL_TOL[dt]
            assert _rel(torch.zeros_like(w), w) > REL_TOL[dt]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_kernel_and_its_gradient_match_plain_on_card(card, dtype):
    """K2 forward against two plain directions; its backward (2 x K3, the
    sum in the input dtype) against the plain backward combined as the
    JAX package's `_bwd` combines it. Each bf16 sum may differ by one step
    of each term and of itself."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(4)
    for p in (64, 169, 1024):
        f1, f2, g1 = _bwd_inputs(gen, 4, p, 512, dt, card)
        g2 = torch.randn(4, p, 512, generator=gen).to(card, dt)
        a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
        o1, o2 = coattn.coattention_fused(a, b, 10.0)
        torch.autograd.backward((o1, o2), (g1, g2))
        torch.cuda.synchronize()
        for got, want in ((o1, coattn.attend_plain(f1, f2, 10.0)),
                          (o2, coattn.attend_plain(f2, f1, 10.0))):
            torch.testing.assert_close(got.detach().float(), want.float(), **TOL[dt])
            assert _rel(got.detach(), want) <= REL_TOL[dt]
        dq1, dkv1 = coattn.attend_bwd_plain(f1, f2, 10.0, g1)
        dq2, dkv2 = coattn.attend_bwd_plain(f2, f1, 10.0, g2)
        for got, x, y in ((a.grad, dq1, dkv2), (b.grad, dkv1, dq2)):
            want = (x + y).float()
            step = 0.0 if dt == torch.float32 else 2 ** -7
            limit = (BWD_TOL[dt]["atol"] + BWD_TOL[dt]["rtol"] * want.abs()
                     + step * (x.float().abs() + y.float().abs()))
            assert ((got.float() - want).abs() <= limit).all()
            assert _rel(got, want) <= REL_TOL[dt]


def test_bwd_kernel_takes_strided_inputs(card):
    """Frames sliced out of a clip and a gradient sliced out of a concat
    (rows not contiguous: the autograd function copies it) give what their
    contiguous copies give."""
    gen = torch.Generator().manual_seed(5)
    clip = _rows(gen, 4, 2, 169, 64).to(card)
    cat = torch.randn(4, 169, 128, generator=gen).to(card)
    got = coattn.attend_bwd(clip[:, 0], clip[:, 1], 10.0,
                            coattn._rows_contiguous(cat[..., 64:]))
    want = coattn.attend_bwd_plain(clip[:, 0].contiguous(),
                                   clip[:, 1].contiguous(), 10.0,
                                   cat[..., 64:].contiguous())
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **BWD_TOL[torch.float32])


@pytest.mark.parametrize("k", [2, 3])
def test_train_step_launches(card, k):
    """One train step of a mini model on the card: k=2 runs K2 once and K3
    twice per scale; k=3 runs K1 and K3 once per scale."""
    from dcnet_tpu_torch.config import DCNetConfig
    from dcnet_tpu_torch.models.darknet import mini_backbone_defs
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.train.state import create_train_state
    from dcnet_tpu_torch.train.step import train_step
    from dcnet_tpu_torch.weights import seeded_init_

    cfg = DCNetConfig(image_size=64, corpus_size=50, emb_size=64,
                      lstm_hidden=64, word_embedding_size=64, n_frames_train=k)
    model = seeded_init_(DCNet(cfg, backbone_defs=mini_backbone_defs(),
                               device=card), seed=0)
    state = create_train_state(model, cfg)
    gen = torch.Generator().manual_seed(6)
    n = 2 * k
    batch = {"images": torch.rand(n, 64, 64, 3, generator=gen),
             "word_ids": torch.randint(1, 50, (n, 20), generator=gen),
             "bbox": torch.tensor([[4.0, 6.0, 40.0, 50.0]] * n)}
    kernels.reset_launches()
    metrics = train_step(state, batch)
    torch.cuda.synchronize()
    want = ({"coattn_attend": 0, "coattn_pair": 3, "coattn_attend_bwd": 6,
             "coattn_ring": 0, "loc_gram": 0} if k == 2 else
            {"coattn_attend": 3, "coattn_pair": 0, "coattn_attend_bwd": 3,
             "coattn_ring": 0, "loc_gram": 0})
    assert kernels.LAUNCHES == want
    assert all(torch.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum", [0.1, 0.999])
def test_bn_train_on_card_matches_its_cpu_branch(card, dtype, momentum):
    """`heads.bn_train` normalises with the card's fused kernel and takes the
    variance back from its 1/sqrt(var + eps); the CPU branch computes
    flax's formula from `torch.var_mean`. Both give the same output,
    gradients and running statistics (biased variance, the module's
    momentum), here with a channel whose mean is 100 times its spread."""
    from torch import nn

    from dcnet_tpu_torch.models.heads import bn_train

    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 8, 64, generator=gen) * torch.rand(64, generator=gen)
    x[..., 0] = 1.5 + 0.015 * x[..., 0]
    g = torch.randn(x.shape, generator=gen)
    start = nn.BatchNorm2d(64, momentum=momentum)
    with torch.no_grad():
        start.weight.copy_(1 + 0.1 * torch.randn(64, generator=gen))
        start.bias.copy_(0.1 * torch.randn(64, generator=gen))
        start.running_mean.copy_(0.3 * torch.randn(64, generator=gen))
        start.running_var.copy_(0.5 + torch.rand(64, generator=gen))
    results = []
    for dev in (card, torch.device("cpu")):
        bn = copy.deepcopy(start).to(dev)
        xi = x.to(dev, dt).requires_grad_()
        y = bn_train(xi, bn)
        y.backward(g.to(dev, dt))
        results.append([t.detach().cpu().float() for t in (
            y, xi.grad, bn.weight.grad, bn.bias.grad,
            bn.running_mean, bn.running_var)])
    # y and dx per element: rtol, plus atol at the scale of the element's
    # channel (an fp32 BatchNorm's rounding error in dx is absolute, about
    # 1e-7 of scale * |g| / std, where dx itself may cancel to near zero)
    tol = BWD_TOL[dt]
    for name, a, w in zip(("y", "dx"), results[0][:2], results[1][:2]):
        scale = w.abs().amax(dim=(0, 1, 2), keepdim=True)
        err = (a - w).abs() / (tol["rtol"] * w.abs() + tol["atol"] * scale)
        assert err.max() <= 1.0, (name, err.max().item(), err.amax((0, 1, 2)))
        assert _rel(a, w) <= REL_TOL[dt], (name, _rel(a, w))
    for name, a, w in zip(("dweight", "dbias", "running_mean", "running_var"),
                          results[0][2:], results[1][2:]):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5,
                                   msg=lambda m, name=name: f"{name}: {m}")
    # the limit tells flax's biased variance from torch's unbiased one
    n = x[..., 0].numel()
    var = x.to(dt).double().var(dim=(0, 1, 2), correction=0)
    unbiased = ((1 - momentum) * start.running_var.double()
                + momentum * var * n / (n - 1)).float()
    assert not torch.allclose(unbiased, results[0][5], rtol=1e-4, atol=1e-5)


def test_kernel_refuses_what_it_cannot_take(card):
    """It raises instead of falling back to the plain version."""
    q = torch.zeros(2, 64, 32, device=card)
    kernels.reset_launches()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        coattn.coattention_one(q.half(), q.half(), 10.0)
    with pytest.raises(ValueError, match="C % 16"):
        coattn.coattention_one(q[..., :24], q[..., :24], 10.0)
    with pytest.raises(ValueError, match="contiguous"):
        coattn.coattention_one(q.transpose(1, 2), q.transpose(1, 2), 10.0)
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattention_one(q, q.cpu(), 10.0)
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattention_fused(q, q.cpu(), 10.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        coattn.attend_bwd(q, q, 10.0, q.bfloat16())
    with pytest.raises(ValueError, match="C <= 512"):
        wide = torch.zeros(1, 16, 528, device=card)
        coattn.attend_bwd(wide, wide, 10.0, wide)
    assert set(kernels.LAUNCHES.values()) == {0}


def _int8_ring(gen, *shape):
    """An int8 ring as the serving engine writes it: l2-normalised rows
    quantised with the static scale 1/127."""
    return torch.clamp(torch.round(_rows(gen, *shape) * 127.0), -127, 127).to(torch.int8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_ring_kernel_matches_plain_on_card(card, dtype):
    """K4 against its plain version at every slot, P 64, 169 and 1024,
    C = 512. Its output is the ring's dtype, bf16 for int8 rings: K1's
    limits for that output dtype (the int8 logits are exact on both sides,
    the rest is K1's bf16 arithmetic)."""
    gen = torch.Generator().manual_seed(7)
    for p in (64, 169, 1024):
        if dtype == "int8":
            ring = _int8_ring(gen, 2, 5, p, 512).to(card)
        else:
            ring = _rows(gen, 2, 5, p, 512).to(card, getattr(torch, dtype))
        for slot in (None, 0, 2, 4):
            got = coattn.coattention_ring(ring, 10.0, 2, newest_slot=slot)
            want = coattn.ring_attend_plain(ring, 10.0, 2, newest_slot=slot)
            torch.cuda.synchronize()
            out_dt = torch.bfloat16 if dtype == "int8" else ring.dtype
            assert got.dtype == out_dt and got.shape == (2, 4, p, 512)
            torch.testing.assert_close(got.float(), want.float(), **TOL[out_dt])
            assert _rel(got, want) <= REL_TOL[out_dt]
            # a kernel that read the frames in physical order would fail
            if slot not in (None, 4):
                blind = coattn.ring_attend_plain(ring, 10.0, 2)
                assert _rel(blind, want) > REL_TOL[out_dt]


def test_ring_kernel_narrow_and_strided_rings(card):
    """A narrow (C = 64) int8 ring with ragged P, and a ring sliced out of a
    wider batch (batch-strided), as the plain version gives them."""
    gen = torch.Generator().manual_seed(8)
    ring = _int8_ring(gen, 3, 5, 169, 64).to(card)
    got = coattn.coattention_ring(ring, 10.0, 2, 1)
    want = coattn.ring_attend_plain(ring, 10.0, 2, 1)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])
    wide = _rows(gen, 4, 5, 64, 64).to(card)
    got = coattn.coattention_ring(wide[::2], 10.0, 1, 3)
    want = coattn.ring_attend_plain(wide[::2].contiguous(), 10.0, 1, 3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL[torch.float32])


def test_ring_kernel_refuses_what_it_cannot_take(card):
    ring = torch.zeros(2, 5, 64, 32, device=card)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattention_ring(ring.cpu(), 10.0, 2)
    with pytest.raises(TypeError, match="int8"):
        coattn.coattention_ring(ring.half(), 10.0, 2)
    with pytest.raises(ValueError, match="C % 16"):
        coattn.coattention_ring(ring[..., :24], 10.0, 2)
    with pytest.raises(ValueError, match="must lie in"):
        coattn.coattention_ring(ring, 10.0, 2, newest_slot=5)
    assert set(kernels.LAUNCHES.values()) == {0}
    coattn.coattention_ring_fused(ring.reshape(2, 5, 8, 8, 32))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["coattn_ring"] == 1


@pytest.mark.parametrize("multiref", [False, True])
def test_serving_tick_launches(card, multiref):
    """A serving tick of a mini model on the card: with coattn_multiref one
    K4 launch per scale and no K1, without it 4 K1 launches per scale."""
    from dcnet_tpu_torch.config import DCNetConfig
    from dcnet_tpu_torch.models.darknet import mini_backbone_defs
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.serving.engine import GroundingEngine
    from dcnet_tpu_torch.weights import seeded_init_

    cfg = DCNetConfig(image_size=64, corpus_size=50, emb_size=64,
                      lstm_hidden=64, word_embedding_size=64,
                      coattn_multiref=multiref)
    model = seeded_init_(DCNet(cfg, backbone_defs=mini_backbone_defs(),
                               device=card), seed=0)
    eng = GroundingEngine(model, n_streams=3, int8_rings=multiref)
    gen = torch.Generator().manual_seed(9)
    state = eng.init_state(torch.randint(1, 50, (3, 20), generator=gen))
    kernels.reset_launches()
    for _ in range(6):
        state, fused, raw, score = eng.step(state, torch.rand(3, 64, 64, 3, generator=gen))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["coattn_ring"] == (18 if multiref else 0)
    assert kernels.LAUNCHES["coattn_attend"] == (0 if multiref else 72)
    assert all(torch.isfinite(x).all() for x in (fused, raw, score))


@pytest.mark.parametrize("c,body", [(128, "wgmma"), (256, "wgmma"), (384, "wgmma"),
                                    (80, "block")])
def test_bf16_block_chosen_by_shape(card, c, body):
    """bf16 K1, K2 and K4 at widths the wgmma block takes (every
    instantiation but C=512, which the tests above run) and one it does
    not (C=80, the WMMA block): the C entry point picks the block by shape,
    as `attend_body` reports it, and either agrees with the plain version
    at ragged and whole P."""
    assert coattn.attend_body(torch.bfloat16, c) == body
    assert coattn._lib().dcnet_coattn_block(1, c) == (body == "wgmma")
    assert coattn._lib().dcnet_coattn_block(0, c) == 0  # fp32: FMA block
    gen = torch.Generator().manual_seed(10)
    dt = torch.bfloat16
    for p in (64, 169, 256):
        q = _rows(gen, 3, p, c).to(card, dt)
        kv = _rows(gen, 3, p, c).to(card, dt)
        got = coattn.coattention_one(q, kv, 10.0)
        with torch.no_grad():
            o1, o2 = coattn.coattention_fused(q, kv, 10.0)
        ring = _rows(gen, 2, 5, p, c).to(card, dt)
        rgot = coattn.coattention_ring(ring, 10.0, 2, newest_slot=1)
        torch.cuda.synchronize()
        for a, w in ((got, coattn.attend_plain(q, kv, 10.0)), (o1, coattn.attend_plain(q, kv, 10.0)),
                     (o2, coattn.attend_plain(kv, q, 10.0)),
                     (rgot, coattn.ring_attend_plain(ring, 10.0, 2, newest_slot=1))):
            torch.testing.assert_close(a.float(), w.float(), **TOL[dt])
            assert _rel(a, w) <= REL_TOL[dt]


# K5 against its plain version: both sum fp32 products of the same values in
# other orders (relative ~1e-6 on outputs of order 0.1-1); bf16 outputs are
# one rounding of those sums, so an element may be one bf16 step apart
# (2^-7 relative). A dropped bias (0.1 of the outputs) or obj, or zeros,
# fail these limits.
K5_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
          torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}


def _loc_gram_inputs(gen, b, p, c, dt, card):
    ce = _rows(gen, b, p, 8).to(card, dt)
    obj = _rows(gen, b, p).to(card)
    w = torch.randn(p, c, generator=gen).to(card)
    bias = (0.1 * torch.randn(c, generator=gen)).to(card)
    return ce, obj, w, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loc_gram_matches_plain_on_card(card, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(11)
    for p in (84, 1344, 3549):
        ce, obj, w, bias = _loc_gram_inputs(gen, 2, p, 512, dt, card)
        got = locgram.fused_loc_gram(ce, obj, w, bias)
        want = locgram.loc_gram_plain(ce, obj, w, bias)
        torch.cuda.synchronize()
        assert got.dtype == dt and got.shape == (2, p, 512)
        torch.testing.assert_close(got.float(), want.float(), **K5_TOL[dt])
        assert _rel(got, want) <= REL_TOL[dt]
        for wrong in (torch.zeros_like(want),
                      locgram.loc_gram_plain(ce, obj, w, torch.zeros_like(bias)),
                      locgram.loc_gram_plain(ce, torch.ones_like(obj), w, bias)):
            assert _rel(wrong, want) > REL_TOL[dt]


def test_loc_gram_refuses_what_it_cannot_take(card):
    gen = torch.Generator().manual_seed(12)
    ce, obj, w, bias = _loc_gram_inputs(gen, 2, 84, 64, torch.float32, card)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        locgram.fused_loc_gram(ce, obj.cpu(), w, bias)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        locgram.fused_loc_gram(ce.half(), obj, w, bias)
    with pytest.raises(TypeError, match="float32"):
        locgram.fused_loc_gram(ce, obj.bfloat16(), w, bias)
    with pytest.raises(ValueError, match="E <= 16"):
        locgram.fused_loc_gram(torch.zeros(2, 84, 17, device=card), obj, w, bias)
    with pytest.raises(ValueError, match="C % 4"):
        locgram.fused_loc_gram(ce, obj, w[:, :62].contiguous(), bias[:62])
    with pytest.raises(ValueError, match="contiguous"):
        locgram.fused_loc_gram(ce, obj, w.t().contiguous().t(), bias)
    with pytest.raises(ValueError, match="disagree"):
        locgram.fused_loc_gram(ce, obj[:, :80], w, bias)
    assert set(kernels.LAUNCHES.values()) == {0}
    locgram.fused_loc_gram(ce, obj, w, bias)
    locgram.fused_loc_gram(ce.bfloat16(), obj, w, bias)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["loc_gram"] == 2
