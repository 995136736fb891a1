"""The CUDA kernels on the card (K1, the pair K2, the backward K3, the ring
kernel K4, the location Gram K5, the int8 convolution K6 and the eval conv
epilogue K7), against their plain PyTorch versions,
the launches of one train step and of serving ticks, the host's waits on
the card in a train step, a tick and an eval call against the program's
`host_syncs` counter, and train-mode BatchNorm's card branch against its
CPU branch.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Without a CUDA card every test here skips: the kernels are CUDA C++ with no
CPU mode (their plain versions are held against the JAX package in
`tests/test_torch_coattn.py`, `tests/test_torch_train_kernels.py`,
`tests/test_torch_ring.py`, `tests/test_torch_locgram.py` and
`tests/test_torch_quant.py`).
"""

import copy

import pytest
import torch

import chip_smoke
from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.kernels import bn_act as k7
from dcnet_tpu_torch.kernels import coattn, conv_s8, locgram

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


@pytest.mark.parametrize("c", [16, 80, 512])
def test_fp32_block_matches_plain_on_card(card, c):
    """The 3xTF32 block at the fp32 limits in K1 (contiguous and
    batch-strided frames of a clip), K2 and K4 (a batch-strided ring, every
    slot), at ragged and whole P; the limits reject zeros and T=1."""
    gen = torch.Generator().manual_seed(13)
    tol = TOL[torch.float32]
    for p in (64, 169, 1024):
        clip = _rows(gen, 3, 5, p, c).to(card)
        q, kv = clip[:, 2], clip[:, 0]  # batch-strided frame views
        want = coattn.attend_plain(q.contiguous(), kv.contiguous(), 10.0)
        for got in (coattn.coattention_one(q, kv, 10.0),
                    coattn.coattention_one(q.contiguous(), kv.contiguous(), 10.0)):
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **tol)
            assert _rel(got, want) <= REL_TOL[torch.float32]
        assert _rel(coattn.attend_plain(q, kv, 1.0), want) > REL_TOL[torch.float32]
        assert _rel(torch.zeros_like(want), want) > REL_TOL[torch.float32]
        with torch.no_grad():
            o1, o2 = coattn.coattention_fused(q, kv, 10.0)
        torch.testing.assert_close(o1, want, **tol)
        torch.testing.assert_close(o2, coattn.attend_plain(kv, q, 10.0), **tol)
        ring = _rows(gen, 4, 5, p, c).to(card)[::2]  # batch-strided ring
        for slot in (None, 0, 3):
            got = coattn.coattention_ring(ring, 10.0, 2, newest_slot=slot)
            want = coattn.ring_attend_plain(ring, 10.0, 2, newest_slot=slot)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **tol)
            assert _rel(got, want) <= REL_TOL[torch.float32]


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [16, 80])
def test_bwd_kernel_narrow_widths(card, dtype, c):
    """K3 at widths whose channel groups own no channels (C=16) or unequal
    counts (C=80), ragged and whole P, against its plain version."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(14)
    for p in (16, 169, 256):
        q, kv, g = _bwd_inputs(gen, 3, p, c, dt, card)
        got = coattn.attend_bwd(q, kv, 10.0, g)
        want = coattn.attend_bwd_plain(q, kv, 10.0, g)
        torch.cuda.synchronize()
        for a, w in zip(got, want):
            torch.testing.assert_close(a.float(), w.float(), **BWD_TOL[dt])
            assert _rel(a, w) <= REL_TOL[dt]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [24, 80, 512])
def test_row_windows_equal_the_full_launch_rows(card, dtype, c):
    """K1, K2 and K3 on row windows (the tensor-parallel co-attention's),
    on every block a width takes (C=24 the general one, 80 the WMMA / the
    fp32 block, 512 wgmma / 3xTF32): each window's rows are the full
    launch's rows, bitwise, K3's dq too; K3's partial dkv over a partition
    sum to the full launch's within its limits; a window past the frame
    raises."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(c)
    p = 100
    q, kv = (_rows(gen, 3, p, c).to(card, dt) for _ in range(2))
    g = torch.randn(3, p, c, generator=gen).to(card, dt)
    with torch.no_grad():
        full1 = coattn.attend_window(q, kv, 10.0, 0, p)
        full2 = coattn.attend_pair_window(q, kv, 10.0, 0, p)
    dq_full, dkv_full = coattn.attend_bwd(q, kv, 10.0, g)
    total = torch.zeros_like(dkv_full, dtype=torch.float32)
    size = torch.zeros_like(total)     # the partials' magnitudes
    for r0, rows in ((0, 37), (37, 1), (38, 62)):
        with torch.no_grad():
            o1 = coattn.attend_window(q, kv, 10.0, r0, rows)
            o2 = coattn.attend_pair_window(q, kv, 10.0, r0, rows)
        assert torch.equal(o1, full1[:, r0:r0 + rows])
        assert all(torch.equal(a, b[:, r0:r0 + rows]) for a, b in zip(o2, full2))
        dq, dkv = coattn.attend_bwd(q, kv, 10.0, g[:, r0:r0 + rows].contiguous(), row0=r0)
        torch.testing.assert_close(dq, dq_full[:, r0:r0 + rows], rtol=0, atol=0)
        total += dkv.float()
        size += dkv.float().abs()
    # each partial and the full dkv round once to the dtype: the limit adds
    # a rounding step of every partial (bf16 2^-7, fp32 1e-5 of its size)
    tol = BWD_TOL[dt]
    step = 2 ** -7 if dt == torch.bfloat16 else 1e-5
    limit = tol["atol"] + tol["rtol"] * dkv_full.float().abs() + step * size
    assert bool(((total - dkv_full.float()).abs() <= limit).all())
    with pytest.raises(ValueError, match="does not lie"):
        coattn.attend_window(q, kv, 10.0, 90, 11)


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
    twice per scale; k=3 runs K1 and K3 once per scale; the training
    forward's BatchNorms never reach K7."""
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
             "coattn_ring": 0, "loc_gram": 0, "conv_s8": 0, "conv_s8_halo": 0,
             "conv_s8_gather": 0, "conv_s8_quant": 0, "bn_act": 0} if k == 2 else
            {"coattn_attend": 3, "coattn_pair": 0, "coattn_attend_bwd": 3,
             "coattn_ring": 0, "loc_gram": 0, "conv_s8": 0, "conv_s8_halo": 0,
             "conv_s8_gather": 0, "conv_s8_quant": 0, "bn_act": 0})
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
    """It raises instead of falling back to the plain version: on dtype,
    device and layout. Widths it takes all (C=24, 528 in K1, K2 and K3)."""
    q = torch.zeros(2, 64, 32, device=card)
    kernels.reset_launches()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        coattn.coattention_one(q.half(), q.half(), 10.0)
    with pytest.raises(ValueError, match="contiguous"):
        coattn.coattention_one(q[..., :24], q[..., :24], 10.0)
    with pytest.raises(ValueError, match="contiguous"):
        coattn.coattention_one(q.transpose(1, 2), q.transpose(1, 2), 10.0)
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattention_one(q, q.cpu(), 10.0)
    with pytest.raises(ValueError, match="CUDA"):
        coattn.coattention_fused(q, q.cpu(), 10.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        coattn.attend_bwd(q, q, 10.0, q.bfloat16())
    assert set(kernels.LAUNCHES.values()) == {0}
    gen = torch.Generator().manual_seed(15)
    for c in (24, 528):
        x, y, g = _bwd_inputs(gen, 2, 64, c, torch.float32, card)
        got = [coattn.coattention_one(x, y, 10.0)]
        got += list(coattn.attend_bwd(x, y, 10.0, g))
        with torch.no_grad():
            got += list(coattn.coattention_fused(x, y, 10.0))
        want = [coattn.attend_plain(x, y, 10.0),
                *coattn.attend_bwd_plain(x, y, 10.0, g),
                coattn.attend_plain(x, y, 10.0), coattn.attend_plain(y, x, 10.0)]
        torch.cuda.synchronize()
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, **TOL[torch.float32])
    assert kernels.LAUNCHES["coattn_attend"] == 2
    assert kernels.LAUNCHES["coattn_attend_bwd"] == 2
    assert kernels.LAUNCHES["coattn_pair"] == 2


# Widths off every configured path: not a multiple of 16, just past the
# tensor-core blocks' 512, twice 512 (the general block and K3's general
# pass); int8 rings also past 1040, where 127² C passes 2^24.
WIDTHS = (24, 528, 1024)


def _close(got, want, dt, tol=None):
    """got within dt's limits (`tol`, K1's by default) of want, and the
    relative l2 limit."""
    torch.testing.assert_close(got.float(), want.float(), **(tol or TOL)[dt])
    assert _rel(got, want) <= REL_TOL[dt]


def _rejected(want, wrong, dt):
    """Zeros and `wrong` (the result at T=1) fail the relative limit."""
    assert _rel(torch.zeros_like(want), want) > REL_TOL[dt]
    assert _rel(wrong, want) > REL_TOL[dt]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", WIDTHS)
def test_forward_kernels_take_every_width(card, dtype, c):
    """K1 (contiguous and batch-strided frames), K2 and K4 (float rings,
    rotated slots) at widths off every configured path, ragged and whole P,
    against their plain versions at today's limits; the limits reject
    zeros and T=1. bf16 at 528 runs the WMMA block, the rest the general
    block."""
    dt = getattr(torch, dtype)
    assert coattn.attend_body(dt, c) == ("block" if (dtype, c) == ("bfloat16", 528)
                                         else "wide")
    gen = torch.Generator().manual_seed(16 + c)
    for p in (64, 169):
        clip = _rows(gen, 2, 5, p, c).to(card, dt)
        q, kv = clip[:, 2], clip[:, 0]
        want = coattn.attend_plain(q, kv, 10.0)
        for got in (coattn.coattention_one(q, kv, 10.0),
                    coattn.coattention_one(q.contiguous(), kv.contiguous(), 10.0)):
            torch.cuda.synchronize()
            _close(got, want, dt)
        _rejected(want, coattn.attend_plain(q, kv, 1.0), dt)
        with torch.no_grad():
            o1, o2 = coattn.coattention_fused(q, kv, 10.0)
        torch.cuda.synchronize()
        _close(o1, want, dt)
        _close(o2, coattn.attend_plain(kv, q, 10.0), dt)
        for slot in (None, 1):
            got = coattn.coattention_ring(clip, 10.0, 2, newest_slot=slot)
            want = coattn.ring_attend_plain(clip, 10.0, 2, newest_slot=slot)
            torch.cuda.synchronize()
            assert got.dtype == dt and got.shape == (2, 4, p, c)
            _close(got, want, dt)
            _rejected(want, coattn.ring_attend_plain(clip, 1.0, 2, slot), dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", WIDTHS)
def test_bwd_kernel_takes_every_width(card, dtype, c):
    """K3's general pass (every width here) against its plain version at
    K3's limits, ragged and whole P, on batch-strided frames; the limits
    reject zeros and T=1."""
    dt = getattr(torch, dtype)
    assert coattn.attend_bwd_body(c) == "wide"
    gen = torch.Generator().manual_seed(17 + c)
    for p in (64, 169):
        clip = _rows(gen, 2, 2, p, c).to(card, dt)
        g = torch.randn(2, p, c, generator=gen).to(card, dt)
        got = coattn.attend_bwd(clip[:, 0], clip[:, 1], 10.0, g)
        want = coattn.attend_bwd_plain(clip[:, 0], clip[:, 1], 10.0, g)
        wrong = coattn.attend_bwd_plain(clip[:, 0], clip[:, 1], 1.0, g)
        torch.cuda.synchronize()
        for a, w, bad in zip(got, want, wrong):
            assert a.dtype == dt and a.shape == (2, p, c)
            _close(a, w, dt, BWD_TOL)
            _rejected(w, bad, dt)


@pytest.mark.parametrize("c", WIDTHS + (1056,))
def test_int8_ring_takes_every_width(card, c):
    """K4 on int8 rings at widths off every configured path (the general
    block), ragged and whole P, rotated slots, at the bf16 output's limits;
    a slot-blind kernel, zeros and T=1 fail them."""
    assert coattn.attend_body(torch.int8, c) == "wide"
    gen = torch.Generator().manual_seed(18 + c)
    for p in (64, 169):
        ring = _int8_ring(gen, 2, 5, p, c).to(card)
        for slot in (None, 0, 3):
            got = coattn.coattention_ring(ring, 10.0, 2, newest_slot=slot)
            want = coattn.ring_attend_plain(ring, 10.0, 2, newest_slot=slot)
            torch.cuda.synchronize()
            assert got.dtype == torch.bfloat16 and got.shape == (2, 4, p, c)
            _close(got, want, torch.bfloat16)
            _rejected(want, coattn.ring_attend_plain(ring, 1.0, 2, slot), torch.bfloat16)
            if slot == 0:
                blind = coattn.ring_attend_plain(ring, 10.0, 2)
                assert _rel(blind, want) > REL_TOL[torch.bfloat16]


@pytest.mark.parametrize("c", [128, 256, 384, 512])
def test_int8_wgmma_block_matches_plain_at_every_slot(card, c):
    """The int8 block (wgmma s8 logits, bf16 wgmma PV on a dequantised copy,
    TMA) at every slot of a 5-frame ring, P 64, 169 and (C = 512) 1024,
    against its plain version at the bf16 output's limits; a slot-blind
    kernel fails them. The C entry point picks this block (code 4)."""
    assert coattn.attend_body(torch.int8, c) == "wgmma_s8"
    assert coattn._lib().dcnet_coattn_block(2, c) == 4
    gen = torch.Generator().manual_seed(19 + c)
    for p in ((64, 169, 1024) if c == 512 else (64, 169)):
        ring = _int8_ring(gen, 2, 5, p, c).to(card)
        for slot in (None, 0, 1, 2, 3, 4):
            got = coattn.coattention_ring(ring, 10.0, 2, newest_slot=slot)
            want = coattn.ring_attend_plain(ring, 10.0, 2, newest_slot=slot)
            torch.cuda.synchronize()
            _close(got, want, torch.bfloat16)
            if slot not in (None, 4):
                blind = coattn.ring_attend_plain(ring, 10.0, 2)
                assert _rel(blind, want) > REL_TOL[torch.bfloat16]
        _rejected(want, coattn.ring_attend_plain(ring, 1.0, 2, 4), torch.bfloat16)


def _deterministic_negatives(generator, pos_idx, num_items, neg_n):
    """The neg_n items after the positive, cyclically: the same negatives
    on the card and on the CPU."""
    steps = torch.arange(1, neg_n + 1, device=pos_idx.device)
    return (pos_idx.long()[..., None] + steps) % num_items


def _plain_launch(q, kv, t, pair):
    """The kernels' plain versions in `coattn._launch_attend`'s place."""
    if pair:
        return coattn.attend_plain(q, kv, t), coattn.attend_plain(kv, q, t)
    return coattn.attend_plain(q, kv, t)


@pytest.mark.parametrize("c", [24, 1024])
def test_train_step_at_any_width(card, c, monkeypatch):
    """A k=2 train step of a mini model at emb_size 24 and 1024 (K2 on the
    general block, K3's general pass), from the same weights and clips
    (dropout 0, the same negatives). bf16: K2 once and K3 twice per scale
    (no K7: the training forward's BatchNorms are the batch's),
    and the losses within rtol 1e-3 of the same card step with the
    kernels' plain versions in their place. fp32: the losses within rtol
    1e-3 of the same step on the CPU. (A bf16 step on the card and on the
    CPU differ by 0.4-2% in these losses at every width, 64 and 512
    included, whose blocks this width work leaves alone: bf16 rounding in
    the convolutions and BatchNorms, not the co-attention.)"""
    from dcnet_tpu_torch.config import DCNetConfig
    from dcnet_tpu_torch.models.darknet import mini_backbone_defs
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.ops import correspondence
    from dcnet_tpu_torch.train.state import create_train_state
    from dcnet_tpu_torch.train.step import train_step
    from dcnet_tpu_torch.weights import seeded_init_

    monkeypatch.setattr(correspondence, "_sample_negatives_excluding",
                        _deterministic_negatives)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gen = torch.Generator().manual_seed(20)
    batch = {"images": torch.rand(4, 64, 64, 3, generator=gen),
             "word_ids": torch.randint(1, 50, (4, 20), generator=gen),
             "bbox": torch.tensor([[4.0, 6.0, 40.0, 50.0]] * 4)}

    def losses(dtype, dev, plain=False):
        cfg = DCNetConfig(image_size=64, corpus_size=50, emb_size=c, lstm_hidden=c,
                          word_embedding_size=64, n_frames_train=2, compute_dtype=dtype,
                          jemb_dropout=0.0, input_dropout=0.0)
        model = seeded_init_(DCNet(cfg, backbone_defs=mini_backbone_defs(), device=dev),
                             seed=0)
        with monkeypatch.context() as m:
            if plain:
                m.setattr(coattn, "_launch_attend", _plain_launch)
                m.setattr(coattn, "attend_bwd", coattn.attend_bwd_plain)
            kernels.reset_launches()
            metrics = train_step(create_train_state(model, cfg), batch)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        return {k: float(v) for k, v in metrics.items() if k.startswith("loss")}, launches

    for dtype, other in (("bfloat16", (card, True)), ("float32", (torch.device("cpu"), False))):
        got, launches = losses(dtype, card)
        assert launches == {"coattn_attend": 0, "coattn_pair": 3, "coattn_attend_bwd": 6,
                            "coattn_ring": 0, "loc_gram": 0, "conv_s8": 0,
                            "conv_s8_halo": 0, "conv_s8_gather": 0, "conv_s8_quant": 0,
                            "bn_act": 0}
        want, _ = losses(dtype, *other)
        for k, w in want.items():
            assert abs(got[k] - w) <= 1e-3 * abs(w), (dtype, k, got[k], w)


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
    with pytest.raises(ValueError, match="contiguous"):
        coattn.coattention_ring(ring[..., :24], 10.0, 2)
    with pytest.raises(ValueError, match="must lie in"):
        coattn.coattention_ring(ring, 10.0, 2, newest_slot=5)
    assert set(kernels.LAUNCHES.values()) == {0}
    coattn.coattention_ring_fused(ring.reshape(2, 5, 8, 8, 32))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["coattn_ring"] == 1
    # a width it once refused (C % 16 != 0), in each ring dtype
    gen = torch.Generator().manual_seed(21)
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        narrow = (_int8_ring(gen, 2, 5, 64, 24) if dt == torch.int8
                  else _rows(gen, 2, 5, 64, 24).to(dt)).to(card)
        got = coattn.coattention_ring(narrow, 10.0, 2, newest_slot=1)
        want = coattn.ring_attend_plain(narrow, 10.0, 2, newest_slot=1)
        torch.cuda.synchronize()
        _close(got, want, want.dtype)
    assert kernels.LAUNCHES["coattn_ring"] == 4


@pytest.mark.parametrize("multiref", [False, True])
def test_serving_tick_launches(card, multiref):
    """A serving tick of a mini model on the card: with coattn_multiref one
    K4 launch per scale and no K1, without it 4 K1 launches per scale; one
    K7 launch per float conv epilogue (`chip_smoke.bn_act_per_call`)."""
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
    per_tick = chip_smoke.bn_act_per_call(cfg, defs=mini_backbone_defs())
    assert per_tick == (26 if multiref else 35)
    assert kernels.LAUNCHES["bn_act"] == 6 * per_tick
    assert all(torch.isfinite(x).all() for x in (fused, raw, score))


def _syncs(fn):
    """fn() under `torch.cuda.set_sync_debug_mode("warn")`: its result and
    the synchronising calls it made, each as the innermost three Python
    frames (`file:line`) that led to it."""
    import traceback
    import warnings

    found = []

    def seen(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            stack = [f for f in traceback.extract_stack()[:-1]
                     if not f.filename.endswith("warnings.py")]
            found.append(" <- ".join(f"{f.filename.split('/site-packages/')[-1]}:{f.lineno}"
                                     for f in stack[-3:][::-1]))

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, found


@pytest.mark.parametrize("path", ["train", "tick", "tick_eager", "eval"])
def test_host_syncs_count_every_wait_on_the_card(card, path):
    """The synchronising calls of one train step, one served tick and one
    `eval_clip` with its decode (each after a first, warming call; the
    graphed tick after its slot's warm-up and capture, so a replay; the
    eager tick on an engine with `donate_state=False`), against the
    `host_syncs` their root spans counted: equal in the step, none in the
    ticks and the eval call. A replayed tick's spans are `engine.copy_in`
    and `engine.replay` alone."""
    from dcnet_tpu_torch.config import DCNetConfig
    from dcnet_tpu_torch.models.darknet import mini_backbone_defs
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.ops.decode import decode_best
    from dcnet_tpu_torch.serving.engine import GroundingEngine
    from dcnet_tpu_torch.train.state import create_train_state
    from dcnet_tpu_torch.train.step import train_step
    from dcnet_tpu_torch.utils import profiling
    from dcnet_tpu_torch.weights import seeded_init_

    cfg = DCNetConfig(image_size=64, corpus_size=50, emb_size=64, lstm_hidden=64,
                      word_embedding_size=64, coattn_multiref=path == "tick")
    model = seeded_init_(DCNet(cfg, backbone_defs=mini_backbone_defs(), device=card), seed=0)
    gen = torch.Generator().manual_seed(6)
    ids = torch.randint(1, 50, (4, 20), generator=gen).to(card)
    if path == "train":
        state = create_train_state(model, cfg)
        batch = {"images": torch.rand(4, 64, 64, 3, generator=gen).to(card), "word_ids": ids,
                 "bbox": torch.tensor([[4.0, 6.0, 40.0, 50.0]] * 4).to(card)}
        roots = ("train.step",)

        def call():
            return train_step(state, batch)
    elif path in ("tick", "tick_eager"):
        eng = GroundingEngine(model, n_streams=4, int8_rings=True,
                              donate_state=path == "tick")
        box = {"state": eng.init_state(ids)}
        frames = torch.rand(4, 64, 64, 3, generator=gen).to(card)
        roots = ("engine.step",)

        def call():
            # each call writes the same ring slot: the graphed engine's
            # first call warms the slot up, its second captures the slot's
            # graph, its third replays it
            slot = box["state"].slot
            box["state"], *out = eng.step(box["state"], frames)
            box["state"] = box["state"]._replace(slot=slot)
            return out
    else:
        images = torch.rand(20, 64, 64, 3, generator=gen).to(card)
        roots = ("dcnet.eval_clip", "decode.best")

        def call():
            return decode_best(model.eval_clip(images, ids).outbox, cfg)
    call()
    if path == "tick":
        call()
    _, syncs = _syncs(call)
    counted = sum(profiling.root_calls(r, 1)[0].counts["host_syncs"] for r in roots)
    assert len(syncs) == counted, "\n".join(syncs)
    assert counted == (10 if path == "train" else 0), "\n".join(syncs)
    if path.startswith("tick"):
        root = profiling.root_calls("engine.step", 1)[0]
        replayed = path == "tick"
        assert root.counts["graph_replays"] == replayed
        assert root.counts["graph_captures"] == 0
        assert (eng._graphs is not None) == replayed
        if replayed:   # no host stage runs in a replayed tick
            assert [s.name for s in sorted((s for s in profiling.SPANS if s.root is root),
                                           key=lambda s: s.t0)] == [
                "engine.step", "engine.copy_in", "engine.replay"]


def _serving_model(card, **over):
    """A mini bf16 model on the card, multiref, cast as for serving."""
    from dcnet_tpu_torch.config import DCNetConfig
    from dcnet_tpu_torch.models.darknet import mini_backbone_defs
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.serving.engine import cast_params_for_serving
    from dcnet_tpu_torch.weights import seeded_init_

    cfg = DCNetConfig(image_size=64, corpus_size=50, emb_size=64, lstm_hidden=64,
                      word_embedding_size=64, coattn_multiref=True,
                      compute_dtype="bfloat16", **over)
    model = seeded_init_(DCNet(cfg, backbone_defs=mini_backbone_defs(), device=card), seed=0)
    return cast_params_for_serving(model)


def _state_equal(a, b) -> bool:
    from dcnet_tpu_torch.serving.engine import _state_tensors
    return a.slot == b.slot and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(_state_tensors(a), _state_tensors(b), strict=True))


GRAPH_TICKS = 12


@pytest.mark.parametrize("int8_rings", [False, True], ids=["float_rings", "int8_rings"])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_graphed_ticks_equal_the_eager_engine_bitwise(card, quantized, int8_rings, tmp_path):
    """12 ticks of the default engine, which replays a CUDA graph per ring
    slot (every slot replayed at least once), against an eager engine
    (`donate_state=False`) on the same model, bf16 or after `quantize()`:
    outputs and state bitwise each tick, through an `update_queries` on
    half the streams before tick 7 and a saved and reloaded state before
    tick 9; the same kernel launches each tick; n_frame captures and
    ticks - n_frame replays (a capturing tick replays too)."""
    import numpy as np

    from dcnet_tpu_torch.serving.engine import (GroundingEngine, load_stream_state,
                                                save_stream_state)
    from dcnet_tpu_torch.utils.profiling import COUNTERS

    model = _serving_model(card)
    n = 6
    gen = torch.Generator().manual_seed(13)
    ids = torch.randint(1, 50, (n, 20), generator=gen)
    ids_b = torch.randint(1, 50, (n, 20), generator=gen)
    frames = torch.rand(GRAPH_TICKS, n, 64, 64, 3, generator=gen).to(card)
    engines = {"graphed": GroundingEngine(model, n, int8_rings=int8_rings),
               "eager": GroundingEngine(model, n, int8_rings=int8_rings, donate_state=False)}
    if quantized:
        engines["graphed"].quantize(torch.rand(8, 64, 64, 3, generator=gen).to(card), ids[:1])
        engines["eager"].qparams = engines["graphed"].qparams
    states = {k: e.init_state(ids) for k, e in engines.items()}
    before = dict(COUNTERS)
    for t in range(GRAPH_TICKS):
        if t == 7:
            mask = np.arange(n) % 2 == 0
            states = {k: e.update_queries(states[k], ids_b, mask=mask)
                      for k, e in engines.items()}
        if t == 9:
            save_stream_state(str(tmp_path / "state.npz"), states["graphed"])
            states["graphed"] = load_stream_state(str(tmp_path / "state.npz"), card)
        outs, launches = {}, {}
        for k, e in engines.items():
            b = dict(kernels.LAUNCHES)
            states[k], *outs[k] = e.step(states[k], frames[t])
            launches[k] = {key: kernels.LAUNCHES[key] - b[key] for key in b}
        assert launches["graphed"] == launches["eager"], f"tick {t}"
        assert launches["graphed"]["coattn_ring"] == 3
        if quantized:
            assert kernels.conv_s8_launches(launches["graphed"]) > 0
        assert all(torch.equal(a, b) for a, b in zip(outs["graphed"], outs["eager"])), t
        assert _state_equal(states["graphed"], states["eager"]), f"tick {t}"
    n_frame = engines["graphed"].n_frame
    assert COUNTERS["graph_captures"] - before["graph_captures"] == n_frame
    assert COUNTERS["graph_replays"] - before["graph_replays"] == GRAPH_TICKS - n_frame
    assert engines["eager"]._graphs is None


def test_new_trunk_scales_drop_the_graphs(card):
    """After `quantize()`, every slot captured and replayed, new int8 trunk
    scales loaded in place (`set_trunk_scales`) on the shared model: the
    graphed engine ticks eagerly again, bitwise the eager engine's on the
    new scales, rather than replay the constants its captures read."""
    from dcnet_tpu_torch.ops import quant as Q
    from dcnet_tpu_torch.serving.engine import GroundingEngine
    from dcnet_tpu_torch.utils.profiling import COUNTERS

    model = _serving_model(card)
    n, reload = 6, 10
    gen = torch.Generator().manual_seed(19)
    ids = torch.randint(1, 50, (n, 20), generator=gen)
    frames = torch.rand(GRAPH_TICKS, n, 64, 64, 3, generator=gen).to(card)
    engines = {"graphed": GroundingEngine(model, n),
               "eager": GroundingEngine(model, n, donate_state=False)}
    engines["graphed"].quantize(torch.rand(8, 64, 64, 3, generator=gen).to(card), ids[:1])
    engines["eager"].qparams = engines["graphed"].qparams
    states = {k: e.init_state(ids) for k, e in engines.items()}
    before = dict(COUNTERS)
    for t in range(GRAPH_TICKS):
        if t == reload:
            Q.set_trunk_scales(model, {k: v * 1.5 for k, v in Q.trunk_scales(model).items()})
        outs = {}
        for k, e in engines.items():
            states[k], *outs[k] = e.step(states[k], frames[t])
        assert all(torch.equal(a, b) for a, b in zip(outs["graphed"], outs["eager"])), t
        assert _state_equal(states["graphed"], states["eager"]), f"tick {t}"
    n_frame = engines["graphed"].n_frame
    assert COUNTERS["graph_captures"] - before["graph_captures"] == n_frame
    assert COUNTERS["graph_replays"] - before["graph_replays"] == reload - n_frame


def test_exported_tick_equals_the_graphed_engine_bitwise(card, tmp_path):
    """The exported tick (`export_engine`, which traces the eager tick),
    served by `ServingRuntime` from the live engine's first state, against
    the live engine replaying its graphs: outputs bitwise over 12 ticks."""
    from dcnet_tpu_torch.serving.engine import GroundingEngine
    from dcnet_tpu_torch.serving.export import ServingRuntime, export_engine
    from dcnet_tpu_torch.utils.profiling import COUNTERS

    n = 6
    gen = torch.Generator().manual_seed(17)
    ids = torch.randint(1, 50, (n, 20), generator=gen)
    frames = torch.rand(GRAPH_TICKS, n, 64, 64, 3, generator=gen).to(card)
    eng = GroundingEngine(_serving_model(card), n, int8_rings=True)
    export_engine(eng, str(tmp_path))
    rt = ServingRuntime(str(tmp_path), device=card)
    live = eng.init_state(ids)
    served = live._replace(**{k: (tuple(x.clone() for x in v) if isinstance(v, tuple)
                                  else v.clone())
                              for k, v in live._asdict().items() if k != "slot"})
    replays = COUNTERS["graph_replays"]
    for t in range(GRAPH_TICKS):
        live, *got = eng.step(live, frames[t])
        served, *want = rt.step(served, frames[t])
        assert all(torch.equal(a, b) for a, b in zip(got, want)), f"tick {t}"
    assert COUNTERS["graph_replays"] - replays == GRAPH_TICKS - eng.n_frame


_BLOCK_CODE = {"block": 0, "wgmma": 1, "tf32x3": 2, "wide": 3, "wgmma_s8": 4}


@pytest.mark.parametrize("dtype,c,body", [
    ("bfloat16", 128, "wgmma"), ("bfloat16", 256, "wgmma"), ("bfloat16", 384, "wgmma"),
    ("bfloat16", 80, "block"), ("float32", 16, "tf32x3"), ("float32", 80, "tf32x3"),
    ("float32", 256, "tf32x3")])
def test_block_chosen_by_shape(card, dtype, c, body):
    """K1, K2 and K4 at widths of each block but C=512, which the tests
    above run: bf16 on the wgmma block (every instantiation) or the WMMA
    block (C=80), fp32 on the 3xTF32 block (C=16: two of the four channel
    groups own no channels; C=80: groups of unequal width). The C entry
    point picks the block by shape, as `attend_body` reports it, and each
    agrees with the plain version at ragged and whole P."""
    dt = getattr(torch, dtype)
    assert coattn.attend_body(dt, c) == body
    assert coattn._lib().dcnet_coattn_block(coattn._DTYPE_CODE[dt], c) == _BLOCK_CODE[body]
    assert coattn._lib().dcnet_coattn_block(0, 528) == 3  # fp32 past 512: general
    assert coattn._bwd_lib().dcnet_coattn_bwd_block(528) == 3
    gen = torch.Generator().manual_seed(10)
    for p in (64, 169, 256):
        q = _rows(gen, 3, p, c).to(card, dt)
        kv = _rows(gen, 3, p, c).to(card, dt)
        got = coattn.coattention_one(q, kv, 10.0)
        with torch.no_grad():
            o1, o2 = coattn.coattention_fused(q, kv, 10.0)
        ring = _rows(gen, 2, 5, p, c).to(card, dt)
        rgot = coattn.coattention_ring(ring, 10.0, 2, newest_slot=1)
        torch.cuda.synchronize()
        for a, w in ((got, coattn.attend_plain(q, kv, 10.0)),
                     (o1, coattn.attend_plain(q, kv, 10.0)),
                     (o2, coattn.attend_plain(kv, q, 10.0)),
                     (rgot, coattn.ring_attend_plain(ring, 10.0, 2, newest_slot=1))):
            torch.testing.assert_close(a.float(), w.float(), **TOL[dt])
            assert _rel(a, w) <= REL_TOL[dt]


# K5 against `chip_smoke.loc_gram_reference`: fp32 ce against the plain
# version (the TPU kernel's Gram algorithm) on float64 copies, where the
# rank-E kernel's fp32 sums sit ~1e-6 (relative) from the exact outputs;
# bf16 ce against the plain version on the same inputs (fp32 sums, one
# rounding), where an element may be one bf16 step apart (2^-7 relative). A
# dropped bias (0.1 of the outputs) or obj, or zeros, fail these limits.
K5_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
          torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}


def _loc_gram_inputs(gen, b, p, c, dt, card, e=8):
    ce = _rows(gen, b, p, e).to(card, dt)
    obj = _rows(gen, b, p).to(card)
    w = torch.randn(p, c, generator=gen).to(card)
    bias = (0.1 * torch.randn(c, generator=gen)).to(card)
    return ce, obj, w, bias


def _assert_loc_gram_held(got, ce, obj, w, bias):
    dt = ce.dtype
    want = chip_smoke.loc_gram_reference(ce, obj, w, bias)
    assert got.dtype == dt and got.shape == want.shape
    torch.testing.assert_close(got.double(), want.double(), **K5_TOL[dt])
    if not want.any():  # a tiny shape whose every output the ReLU zeroes
        assert not got.any()
        return
    assert _rel(got, want) <= REL_TOL[dt]
    for wrong in (torch.zeros_like(want),
                  chip_smoke.loc_gram_reference(ce, obj, w, torch.zeros_like(bias)),
                  chip_smoke.loc_gram_reference(ce, torch.ones_like(obj), w, bias)):
        assert _rel(wrong, want) > REL_TOL[dt]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loc_gram_matches_plain_on_card(card, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(11)
    for p in (84, 1344, 3549):
        ce, obj, w, bias = _loc_gram_inputs(gen, 2, p, 512, dt, card)
        got = locgram.fused_loc_gram(ce, obj, w, bias)
        torch.cuda.synchronize()
        _assert_loc_gram_held(got, ce, obj, w, bias)


# (B, P, E, C): every value of B {1, 8, 64}, P {1, 63, 1344, 3549}, E {1, 8,
# 17} and C {1, 6, 512, 1028} at least once, the configured shape, ragged
# row tiles and column chunks, E past one chunk of 16, widths with no
# 16-byte vector (C % 4 != 0; bf16 also C = 1028)
LOC_GRAM_SHAPES = [(1, 1, 1, 1), (1, 63, 17, 6), (8, 63, 8, 1028), (8, 1344, 8, 512),
                   (8, 1344, 1, 6), (8, 1344, 17, 1028), (64, 1344, 8, 512),
                   (64, 63, 17, 1), (2, 3549, 8, 512), (1, 3549, 1, 1028)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LOC_GRAM_SHAPES, ids=lambda s: "B{}-P{}-E{}-C{}".format(*s))
def test_loc_gram_takes_every_shape(card, dtype, shape):
    """The rank-E kernel at any B, P, E and C against its reference."""
    b, p, e, c = shape
    gen = torch.Generator().manual_seed(15)
    ce, obj, w, bias = _loc_gram_inputs(gen, b, p, c, getattr(torch, dtype), card, e)
    got = locgram.fused_loc_gram(ce, obj, w, bias)
    torch.cuda.synchronize()
    _assert_loc_gram_held(got, ce, obj, w, bias)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loc_gram_is_bitwise_repeatable(card, dtype):
    """Two calls give the same bytes: every sum runs in an order fixed by
    the shapes (no atomics)."""
    gen = torch.Generator().manual_seed(16)
    for b, p, e, c in ((8, 1344, 8, 512), (2, 3549, 17, 1028)):
        args = _loc_gram_inputs(gen, b, p, c, getattr(torch, dtype), card, e)
        one, two = locgram.fused_loc_gram(*args), locgram.fused_loc_gram(*args)
        torch.cuda.synchronize()
        assert torch.equal(one.view(torch.int16), two.view(torch.int16))


def test_loc_gram_refuses_what_it_cannot_take(card):
    """The refusals that remain (device, dtype, shape agreement, layout);
    E = 17 and a width that is not a multiple of 4 launch and are held
    against the reference."""
    gen = torch.Generator().manual_seed(12)
    ce, obj, w, bias = _loc_gram_inputs(gen, 2, 84, 64, torch.float32, card)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        locgram.fused_loc_gram(ce, obj.cpu(), w, bias)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        locgram.fused_loc_gram(ce.half(), obj, w, bias)
    with pytest.raises(TypeError, match="float32"):
        locgram.fused_loc_gram(ce, obj.bfloat16(), w, bias)
    with pytest.raises(ValueError, match="contiguous"):
        locgram.fused_loc_gram(ce, obj, w.t().contiguous().t(), bias)
    with pytest.raises(ValueError, match="disagree"):
        locgram.fused_loc_gram(ce, obj[:, :80], w, bias)
    with pytest.raises(ValueError, match="B <= 65535"):
        locgram.fused_loc_gram(torch.zeros(65536, 1, 1, device=card),
                               torch.zeros(65536, 1, device=card), w[:1], bias)
    assert set(kernels.LAUNCHES.values()) == {0}
    ce17 = _rows(gen, 2, 84, 17).to(card)
    for args in ((ce17, obj, w, bias), (ce, obj, w[:, :62].contiguous(), bias[:62]),
                 (ce, obj, w, bias), (ce.bfloat16(), obj, w, bias)):
        got = locgram.fused_loc_gram(*args)
        torch.cuda.synchronize()
        _assert_loc_gram_held(got, *args)
    assert kernels.LAUNCHES["loc_gram"] == 4


def test_k3_fp32_matches_float64_on_train_step_inputs(card):
    """fp32 K3 on the inputs and upstream gradients a k=2 train step of a
    mini model (emb 512) hands it, against the plain version in float64 at
    `chip_smoke.py`'s limits (K3_F64_TOL); the plain fp32 version sits at
    or under a tenth of them, and they reject zeros, T=1 and a K3 that
    skips a streamed tile (`chip_smoke.check_k2_k3_on_model` raises
    otherwise)."""
    from dcnet_tpu_torch.config import DCNetConfig
    from dcnet_tpu_torch.models.darknet import mini_backbone_defs
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.train.state import create_train_state
    from dcnet_tpu_torch.weights import seeded_init_

    cfg = DCNetConfig(image_size=64, corpus_size=50, emb_size=512, lstm_hidden=512,
                      word_embedding_size=64, n_frames_train=2)
    model = seeded_init_(DCNet(cfg, backbone_defs=mini_backbone_defs(), device=card),
                         seed=0)
    gen = torch.Generator().manual_seed(21)
    batch = {"images": torch.rand(8, 64, 64, 3, generator=gen).to(card),
             "word_ids": torch.randint(1, 50, (8, 20), generator=gen).to(card),
             "bbox": torch.tensor([[4.0, 6.0, 40.0, 50.0]] * 8).to(card)}
    res = chip_smoke.check_k2_k3_on_model(create_train_state(model, cfg), batch)
    held = res["k3_vs_float64"]
    assert res["scales"] == 3
    assert held["share_of_limit"] <= 1.0
    assert held["plain_fp32_share_of_limit"] <= chip_smoke.K3_PLAIN_SHARE
    assert held["limits_reject"] == {"zeros": True, "T1": True, "dropped_tile": True}


# K6: (k, stride, Ci, Co, H, W): every gather width (Ci % 16 == 0: 16
# bytes; Ci % 4 == 0: 4; else single bytes), Co past a 64-column tile and
# odd, rows past a 128-row tile, strides 1 and 2
CONV_CASES = ((3, 1, 3, 32, 17, 19), (3, 2, 32, 64, 16, 16), (1, 1, 64, 255, 9, 7),
              (3, 1, 40, 24, 8, 8), (1, 1, 1032, 512, 6, 6), (3, 2, 5, 17, 11, 13),
              (3, 1, 512, 96, 5, 5), (1, 1, 8, 1, 33, 1))


def _conv_inputs(gen, k, ci, co, h, w, n=2):
    x = torch.randint(-127, 128, (n, h, w, ci), generator=gen, dtype=torch.int8)
    wt = torch.randint(-127, 128, (co, k, k, ci), generator=gen, dtype=torch.int8)
    scale = torch.rand(co, generator=gen) * 1e-4
    bias = torch.randn(co, generator=gen)
    return x, wt, scale, bias


def _conv_epilogues(gen, co, inv):
    """Each epilogue mode of K6, as keyword arguments."""
    s2, b2 = 1 + 0.1 * torch.randn(co, generator=gen), torch.randn(co, generator=gen)
    return {"int32": {},
            "fp32_leaky": dict(act="leaky", out_dtype=torch.float32),
            "bf16": dict(out_dtype=torch.bfloat16),
            "int8": dict(act="leaky", out_dtype=torch.int8, inv_out=inv),
            "bn_relu": dict(scale2=s2, bias2=b2, act="relu", out_dtype=torch.bfloat16)}


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "k{}s{}-ci{}-co{}-{}x{}".format(*c))
def test_conv_s8_equals_plain_bitwise(card, case):
    """Every epilogue mode bitwise equal to the plain version (exact int32
    sums; the FMAs emulated exactly)."""
    k, stride, ci, co, h, w = case
    gen = torch.Generator().manual_seed(ci * 1000 + co)
    x, wt, scale, bias = _conv_inputs(gen, k, ci, co, h, w)
    for i, (name, epi) in enumerate(
            _conv_epilogues(gen, co, 2.0 / (127 * 127 * k * k)).items()):
        if name != "int32":
            epi = dict(epi, scale=scale, bias=bias)
        want = conv_s8.conv_s8(x, wt, stride, (k - 1) // 2, **epi)
        got = conv_s8.conv_s8(x.to(card), wt.to(card),
                              stride, (k - 1) // 2,
                              **{a: v.to(card) if isinstance(v, torch.Tensor) else v
                                 for a, v in epi.items()})
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(got.cpu(), want), (name, (got.cpu().float() - want.float()).abs().max())
    assert conv_s8.conv_vec(ci, x, wt) == (16 if ci % 16 == 0 else 4 if ci % 4 == 0 else 1)


def test_conv_s8_addend_and_stacked_rows(card):
    """The split corr_conv's int32 addend, read once for R stacked parts."""
    gen = torch.Generator().manual_seed(7)
    b, r, h, w, ci, co = 3, 4, 5, 6, 64, 80
    x, wt, scale, bias = _conv_inputs(gen, 1, ci, co, h, w, n=b * r)
    addend = torch.randint(-10 ** 6, 10 ** 6, (b, h, w, co), generator=gen, dtype=torch.int32)
    epi = dict(scale=scale, bias=bias, out_dtype=torch.float32, addend=addend,
               addend_hw=h * w, addend_rep=r)
    want = conv_s8.conv_s8(x, wt, **epi)
    got = conv_s8.conv_s8(x.to(card), wt.to(card),
                          **{a: v.to(card) if isinstance(v, torch.Tensor) else v
                             for a, v in epi.items()})
    assert torch.equal(got.cpu(), want)
    raw = conv_s8.conv_s8_acc_plain(x, wt).reshape(b, r, h, w, co) + addend[:, None]
    torch.testing.assert_close(want.reshape(b, r, h, w, co),
                               conv_s8.fma32(raw.float(), scale, bias), rtol=0, atol=0)


def _misaligned(t, card, offset=4):
    """A copy of t on the card whose data starts `offset` elements past a
    16-byte boundary."""
    big = torch.zeros(t.numel() + offset, dtype=t.dtype, device=card)
    out = big[offset:].view(t.shape)
    out.copy_(t.to(card))
    return out


def test_conv_s8_takes_misaligned_inputs(card):
    """An int8 x whose data is not 16-byte aligned takes the gather route
    at a narrower gather; a misaligned bf16 x, or an int8 x whose channels
    are padded, is copied by the quantize pass and keeps the TMA route."""
    gen = torch.Generator().manual_seed(3)
    x, wt, _, _ = _conv_inputs(gen, 3, 64, 32, 8, 8)
    xa = _misaligned(x, card)
    assert conv_s8.conv_vec(64, xa, wt.to(card)) == 4
    assert conv_s8.plan_for(xa, wt.to(card), 1, 1).route == "gather"
    kernels.reset_launches()
    got = conv_s8.conv_s8(xa, wt.to(card), 1, 1)
    assert kernels.LAUNCHES["conv_s8_gather"] == 1 and kernels.conv_s8_launches() == 1
    assert kernels.LAUNCHES["conv_s8_quant"] == 0
    assert torch.equal(got.cpu(), conv_s8.conv_s8_acc_plain(x, wt, 1, 1))
    xf = torch.randn(2, 8, 8, 64, generator=gen).to(torch.bfloat16)
    xfa = _misaligned(xf, card, offset=1)
    assert conv_s8.plan_for(xfa, wt.to(card), 1, 1).route == "tma"
    got = conv_s8.conv_s8(xfa, wt.to(card), 1, 1, in_inv=30.0)
    assert kernels.LAUNCHES["conv_s8_quant"] == 1
    assert torch.equal(got.cpu(), conv_s8.conv_s8_plain(xf, wt, 1, 1, in_inv=30.0))
    xi, wi, _, _ = _conv_inputs(gen, 1, 1032, 64, 4, 4)
    xia, wia = _misaligned(xi, card, offset=8), _misaligned(wi, card, offset=8)
    plan = conv_s8.plan_for(xia, wia, 1, 0)
    assert plan.route == "tma" and plan.pad_w and plan.cp == 1040
    got = conv_s8.conv_s8(xia, wia)
    assert kernels.LAUNCHES["conv_s8_quant"] == 3 and kernels.LAUNCHES["conv_s8"] == 2
    assert kernels.conv_s8_launches() == 3
    assert torch.equal(got.cpu(), conv_s8.conv_s8_acc_plain(xi, wi))


# K6's routes: (k, stride, Ci, Co, H, W, N, route) -- the headline 3x3 on 8
# frames (split-K), a stride-2 3x3 (four phase maps, 64-byte boxes), Co =
# 255 on a 1x1, Ci = 72 and Ci = 1032 padded by the quantize pass, Ci = 64
# at odd sides; the halo route at a thin reduction (a 1x1 128 -> 64); the
# gather route at a thin reduction whose rows of x are not 16-byte
# multiples (Ci = 3 at W = 31) and at an odd height at stride 2
ROUTE_CASES = ((3, 1, 256, 512, 16, 16, 8, "tma"), (3, 2, 64, 128, 16, 16, 2, "tma"),
               (1, 1, 1024, 255, 8, 8, 8, "tma"), (3, 1, 72, 32, 33, 31, 2, "tma"),
               (1, 1, 1032, 512, 6, 6, 3, "tma"), (3, 1, 64, 80, 9, 10, 2, "tma"),
               (3, 1, 3, 32, 33, 31, 2, "gather"), (1, 1, 128, 64, 9, 7, 2, "halo"),
               (3, 2, 64, 64, 11, 12, 2, "gather"))


@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=lambda c: "k{}s{}-ci{}-co{}-{}x{}-n{}-{}".format(*c))
@pytest.mark.parametrize("xdtype", ["int8", "bfloat16", "float32"])
def test_conv_s8_each_route_bitwise(card, case, xdtype):
    """Each route, in every epilogue mode and input type, bitwise equal to
    the plain version; one K6 launch a call, and the quantize passes the
    plan asks for (w's padded copy made at the first call only)."""
    k, stride, ci, co, h, w, n, route = case
    gen = torch.Generator().manual_seed(ci * 7 + co + k)
    x, wt, scale, bias = _conv_inputs(gen, k, ci, co, h, w, n=n)
    quant = {}
    if xdtype != "int8":
        x = torch.randn(n, h, w, ci, generator=gen).to(getattr(torch, xdtype))
        amax = x.float().abs().max()
        quant = dict(in_inv=float(100.0 / amax)) if xdtype == "bfloat16" else \
            dict(in_scale=amax / 100.0)
    xc, wc = x.to(card), wt.to(card)
    plan = conv_s8.plan_for(xc, wc, stride, (k - 1) // 2)
    assert plan.route == route, plan.why
    for i, (name, epi) in enumerate(
            _conv_epilogues(gen, co, 2.0 / (127 * 127 * k * k)).items()):
        epi = dict(epi, **quant)
        if name != "int32":
            epi = dict(epi, scale=scale, bias=bias)
        want = conv_s8.conv_s8(x, wt, stride, (k - 1) // 2, **epi)
        kernels.reset_launches()
        got = conv_s8.conv_s8(xc, wc, stride, (k - 1) // 2,
                              **{a: v.to(card) if isinstance(v, torch.Tensor) else v
                                 for a, v in epi.items()})
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[kernels.CONV_S8_KEYS[route]] == 1
        assert kernels.conv_s8_launches() == 1
        assert kernels.LAUNCHES["conv_s8_quant"] == (
            (plan.quant_x + (plan.pad_w and i == 0)) if route == "tma" else 0)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(got.cpu(), want), (name, (got.cpu().float() - want.float()).abs().max())


def _float_x(gen, xdtype, n, h, w, ci):
    """A float x and the quantize arguments that put its largest value at
    code 100: x * in_inv for bf16 (the backbone's), x / in_scale for fp32
    (the trunk's)."""
    x = torch.randn(n, h, w, ci, generator=gen).to(getattr(torch, xdtype))
    amax = x.float().abs().max()
    return x, (dict(in_inv=float(100.0 / amax)) if xdtype == "bfloat16"
               else dict(in_scale=amax / 100.0))


def _held_bitwise(card, x, wt, stride, pad, epi, route, acc=None):
    """One K6 call on the card against the plain version, bitwise: one
    launch on `route`, no quantize pass (`acc`: the plain int32 sums,
    computed once for several epilogues)."""
    xc, wc = x.to(card), wt.to(card)
    assert conv_s8.plan_for(xc, wc, stride, pad).route == route
    if acc is None:
        want = conv_s8.conv_s8(x, wt, stride, pad, **epi)
    else:
        want = conv_s8.epilogue_plain(acc, **{a: v for a, v in epi.items()
                                              if a not in ("in_inv", "in_scale")})
    kernels.reset_launches()
    got = conv_s8.conv_s8(xc, wc, stride, pad,
                          **{a: v.to(card) if isinstance(v, torch.Tensor) else v
                             for a, v in epi.items()})
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[kernels.CONV_S8_KEYS[route]] == 1
    assert kernels.conv_s8_launches() == 1
    assert kernels.LAUNCHES["conv_s8_quant"] == 0
    assert got.dtype == want.dtype and got.shape == want.shape
    return torch.equal(got.cpu(), want), (got.cpu().double() - want.double()).abs().max()


# the halo route at the paths' thin shapes (k, stride, Ci, Co, side, N): the
# first layer, the 3x3 s2 32 -> 64 at 256, the 1x1 64 -> 32 and 3x3 32 -> 64
# at 128, the 1x1 128 -> 64 at 64, on 2-3 frames
HALO_PATH_CASES = ((3, 1, 3, 32, 256, 2), (3, 2, 32, 64, 256, 2), (1, 1, 64, 32, 128, 3),
                   (3, 1, 32, 64, 128, 2), (1, 1, 128, 64, 64, 3))


@pytest.mark.parametrize("case", HALO_PATH_CASES,
                         ids=lambda c: "k{}s{}-ci{}-co{}-{}-n{}".format(*c))
@pytest.mark.parametrize("xdtype", ["int8", "bfloat16", "float32"])
def test_conv_s8_halo_path_shapes_bitwise(card, case, xdtype):
    """The halo route at each thin shape of the paths, in every epilogue
    mode and input type, bitwise equal to the plain version."""
    k, stride, ci, co, side, n = case
    gen = torch.Generator().manual_seed(ci * 5 + co + k + stride)
    x, wt, scale, bias = _conv_inputs(gen, k, ci, co, side, side, n=n)
    quant = {}
    if xdtype != "int8":
        x, quant = _float_x(gen, xdtype, n, side, side, ci)
    acc = conv_s8.conv_s8_acc_plain(conv_s8.quantize_plain(x, **quant), wt, stride,
                                    (k - 1) // 2)
    for name, epi in _conv_epilogues(gen, co, 2.0 / (127 * 127 * k * k)).items():
        epi = dict(epi, **quant)
        if name != "int32":
            epi = dict(epi, scale=scale, bias=bias)
        equal, err = _held_bitwise(card, x, wt, stride, (k - 1) // 2, epi, "halo", acc)
        assert equal, (name, err)


# the halo route off the paths (k, stride, Ci, Co, H, W, N): Ci 3 / 4 / 16 /
# 24 / 32 (halo pixels of 4, 16 and 32 bytes; the flat row map for the
# channels that are not 16-byte pixels), Co 32 / 64 / 40 / 80 (passes of 64
# columns), odd sides and tiles cut by the image's edges
HALO_CASES = ((3, 1, 3, 32, 17, 16, 2), (3, 1, 4, 64, 9, 12, 2), (3, 2, 16, 32, 13, 11, 3),
              (3, 1, 24, 64, 7, 10, 1), (3, 1, 32, 32, 15, 9, 2), (1, 1, 16, 64, 5, 7, 3),
              (3, 1, 16, 80, 11, 13, 2), (3, 2, 24, 40, 9, 14, 1))


@pytest.mark.parametrize("case", HALO_CASES,
                         ids=lambda c: "k{}s{}-ci{}-co{}-{}x{}-n{}".format(*c))
@pytest.mark.parametrize("xdtype", ["int8", "bfloat16", "float32"])
def test_conv_s8_halo_any_thin_shape_bitwise(card, case, xdtype):
    """The halo route at thin shapes no path runs, in the int32 and int8-out
    modes and bf16 out with an addend, bitwise equal to the plain
    version."""
    k, stride, ci, co, h, w, n = case
    gen = torch.Generator().manual_seed(ci * 3 + co + h)
    x, wt, scale, bias = _conv_inputs(gen, k, ci, co, h, w, n=n)
    quant = {}
    if xdtype != "int8":
        x, quant = _float_x(gen, xdtype, n, h, w, ci)
    pad = (k - 1) // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    addend = torch.randint(-10 ** 5, 10 ** 5, (n, ho, wo, co), generator=gen,
                           dtype=torch.int32)
    modes = _conv_epilogues(gen, co, 2.0 / (127 * 127 * k * k))
    for name, epi in (("int32", {}), ("int8", dict(modes["int8"], scale=scale, bias=bias)),
                      ("bf16_addend", dict(modes["bn_relu"], scale=scale, bias=bias,
                                           addend=addend, addend_hw=ho * wo))):
        equal, err = _held_bitwise(card, x, wt, stride, pad, dict(epi, **quant), "halo")
        assert equal, (name, err)


def test_conv_s8_halo_refused_tensor_map_raises(card):
    """A tensor map the CUDA driver refuses (a stride that is not a multiple
    of 16 bytes) raises on the halo route; nothing launches and nothing
    falls back."""
    gen = torch.Generator().manual_seed(15)
    x, wt, _, _ = _conv_inputs(gen, 3, 32, 64, 16, 16)
    xc, wc = x.to(card), wt.to(card)
    plan = conv_s8.plan_for(xc, wc, 1, 1)
    assert plan.route == "halo"
    bad = plan.array()
    bad[conv_s8.HALO_FIELDS.index("s1")] += 8
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="refused the tensor map of x"):
        conv_s8._conv_halo(plan, xc, wc, (None,) * 4, None, 1, 1, torch.int32, None, None,
                           None, None, plan_array=bad)
    assert kernels.conv_s8_launches() == 0


def test_conv_s8_pads_constant_weights_once(card):
    """A w whose channels are padded (Ci 1032) goes through the quantize
    pass at its first call only, x (padded too) at every call; written in
    place, w is padded again and the result follows it."""
    gen = torch.Generator().manual_seed(14)
    x, wt, _, _ = _conv_inputs(gen, 1, 1032, 64, 4, 4, n=2)
    xc, wc = x.to(card), wt.to(card)
    plan = conv_s8.plan_for(xc, wc, 1, 0)
    assert plan.route == "tma" and plan.pad_w and plan.quant_x
    kernels.reset_launches()
    for _ in range(3):
        got = conv_s8.conv_s8(xc, wc)
    assert kernels.LAUNCHES["conv_s8_quant"] == 3 + 1 and kernels.LAUNCHES["conv_s8"] == 3
    assert torch.equal(got.cpu(), conv_s8.conv_s8_acc_plain(x, wt))
    wt[:, :, :, 1030] = 127
    wc[:, :, :, 1030] = 127
    assert conv_s8.pad_w_due(wc, 1040)
    got = conv_s8.conv_s8(xc, wc)
    assert kernels.LAUNCHES["conv_s8_quant"] == 4 + 2
    assert torch.equal(got.cpu(), conv_s8.conv_s8_acc_plain(x, wt))


@pytest.mark.parametrize("ci", [1024, 256])
def test_conv_s8_split_k_with_addend_and_stacked_rows(card, ci):
    """The split corr_conv's int32 addend, read once for R stacked parts,
    in fp32 and int8 out: under split-K (Ci 1024: the partial tiles summed
    across the cluster) and under one split (Ci 256: fp32 out takes the
    epilogue straight from the accumulators, int8 out the staged one)."""
    gen = torch.Generator().manual_seed(11)
    b, r, h, w, co = 2, 3, 8, 8, 256
    x, wt, scale, bias = _conv_inputs(gen, 1, ci, co, h, w, n=b * r)
    plan = conv_s8.plan_for(x.to(card), wt.to(card), 1, 0)
    assert plan.route == "tma" and (plan.splits >= 2) == (ci == 1024)
    addend = torch.randint(-10 ** 6, 10 ** 6, (b, h, w, co), generator=gen, dtype=torch.int32)
    for out in (dict(out_dtype=torch.float32), dict(out_dtype=torch.int8, inv_out=1e-3,
                                                   act="leaky")):
        epi = dict(out, scale=scale, bias=bias, addend=addend, addend_hw=h * w, addend_rep=r)
        want = conv_s8.conv_s8(x, wt, **epi)
        got = conv_s8.conv_s8(x.to(card), wt.to(card),
                              **{a: v.to(card) if isinstance(v, torch.Tensor) else v
                                 for a, v in epi.items()})
        assert torch.equal(got.cpu(), want)
    raw = conv_s8.conv_s8(x.to(card), wt.to(card))
    assert torch.equal(raw.cpu(), conv_s8.conv_s8_acc_plain(x, wt))


def test_conv_s8_refused_tensor_map_raises(card):
    """A tensor map the CUDA driver refuses (a stride that is not a multiple of
    16 bytes) raises; nothing launches and nothing falls back."""
    gen = torch.Generator().manual_seed(12)
    x, wt, _, _ = _conv_inputs(gen, 3, 64, 64, 8, 8)
    xc, wc = x.to(card), wt.to(card)
    plan = conv_s8.plan_for(xc, wc, 1, 1)
    bad = plan.array()
    bad[len(conv_s8.TMA_FIELDS) + 5] += 8   # the first phase map's W stride
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="refused a tensor map of x"):
        conv_s8._conv_tma(plan, xc, wc, (None,) * 4, None, 1, 1, torch.int32, None, None,
                          None, None, plan_array=bad)
    assert kernels.conv_s8_launches() == 0


def test_conv_s8_quant_pass_bitwise(card):
    """The quantize pass on the card equals its plain version: bf16 and fp32
    x (aligned or not, whole or ragged 16-channel chunks), int8 copied with
    its channels padded."""
    gen = torch.Generator().manual_seed(13)
    for dt, ci, cp, off in ((torch.bfloat16, 256, 256, 0), (torch.bfloat16, 1032, 1040, 1),
                            (torch.float32, 3, 16, 0), (torch.float32, 40, 48, 3)):
        x = (torch.randn(3, 5, 7, ci, generator=gen) * 3).to(dt)
        xc = _misaligned(x, card, off) if off else x.to(card)
        for quant in (dict(in_inv=37.0), dict(in_scale=torch.tensor(0.03))):
            want = conv_s8.quant_pass_plain(x, cp, **quant)
            got = conv_s8.quant_pass(xc, cp, **{a: v.to(card) if isinstance(v, torch.Tensor)
                                                else v for a, v in quant.items()})
            assert torch.equal(got.cpu(), want), (dt, ci, quant)
    xi = torch.randint(-127, 128, (4, 3, 1032), generator=gen, dtype=torch.int8)
    assert torch.equal(conv_s8.quant_pass(xi.to(card), 1040).cpu(),
                       conv_s8.quant_pass_plain(xi, 1040))


def test_conv_s8_refuses_what_it_cannot_take(card):
    gen = torch.Generator().manual_seed(4)
    x, wt, scale, bias = _conv_inputs(gen, 3, 16, 16, 8, 8)
    xc, wc = x.to(card), wt.to(card)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="one CUDA device"):
        conv_s8.conv_s8(xc, wt)
    with pytest.raises(TypeError, match="int8"):
        conv_s8.conv_s8(xc.half(), wc, in_inv=1.0)
    with pytest.raises(ValueError, match="in_inv"):
        conv_s8.conv_s8(xc.float(), wc)
    with pytest.raises(ValueError, match="contiguous"):
        conv_s8.conv_s8(xc.transpose(1, 2), wc)
    with pytest.raises(ValueError, match="inv_out"):
        conv_s8.conv_s8(xc, wc, scale=scale.to(card), bias=bias.to(card),
                        out_dtype=torch.int8)
    with pytest.raises(ValueError, match="scale"):
        conv_s8.conv_s8(xc, wc, out_dtype=torch.float32)
    assert kernels.conv_s8_launches() == 0


def test_int8_backbone_on_card_equals_cpu(card):
    """The int8 backbone (mini defs, 64 px) on the card equals the CPU's
    bitwise in fp32 activations, with and without the int8 chain; one K6
    launch per live conv."""
    from dcnet_tpu_torch.config import DCNetConfig
    from dcnet_tpu_torch.models.darknet import mini_backbone_defs
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.ops import quant
    from dcnet_tpu_torch.weights import seeded_init_

    cfg = DCNetConfig(image_size=64, corpus_size=50, emb_size=64, lstm_hidden=64,
                      word_embedding_size=64)
    model = seeded_init_(DCNet(cfg, backbone_defs=mini_backbone_defs(), device="cpu"))
    images = torch.rand(6, 64, 64, 3, generator=torch.Generator().manual_seed(5))
    qp = quant.quantize_model_backbone(model, images)
    qp_card = {i: {k: v.to(card) if isinstance(v, torch.Tensor) else v for k, v in d.items()}
               for i, d in qp.items()}
    defs = model.visumodel.layer_defs
    live = len([i for i in quant.conv_layer_ids(defs) if i in quant.live_layers(defs)])
    for chain in (False, True):
        want = quant.backbone_apply_int8(defs, qp, images, int8_chain=chain)
        kernels.reset_launches()
        got = quant.backbone_apply_int8(defs, qp_card, images.to(card), int8_chain=chain)
        torch.cuda.synchronize()
        assert kernels.conv_s8_launches() == live
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("case", CONV_CASES[:6], ids=lambda c: "k{}s{}-ci{}-co{}-{}x{}".format(*c))
@pytest.mark.parametrize("xdtype", ["bfloat16", "float32"])
def test_conv_s8_quantizes_float_inputs(card, case, xdtype):
    """A float x quantized as K6 gathers it (x * in_inv, the backbone's; x /
    in_scale, the trunk's) equals the plain version bitwise."""
    k, stride, ci, co, h, w = case
    gen = torch.Generator().manual_seed(ci + co)
    _, wt, scale, bias = _conv_inputs(gen, k, ci, co, h, w)
    xf = torch.randn(2, h, w, ci, generator=gen).to(getattr(torch, xdtype))
    amax = xf.float().abs().max()
    for quant in (dict(in_inv=float(100.0 / amax)), dict(in_scale=amax / 100.0)):
        epi = dict(quant, scale=scale, bias=bias, act="leaky", out_dtype=torch.bfloat16)
        want = conv_s8.conv_s8(xf, wt, stride, (k - 1) // 2, **epi)
        got = conv_s8.conv_s8(xf.to(card), wt.to(card), stride, (k - 1) // 2,
                              **{a: v.to(card) if isinstance(v, torch.Tensor) else v
                                 for a, v in epi.items()})
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (list(quant), (got.cpu().float() - want.float()).abs().max())


# --------------------------------------------------------------------------
# K7: BatchNorm on the running statistics, activation and shortcut add
# --------------------------------------------------------------------------

# the served tick's channel counts (Darknet-53 and the trunk at emb 512),
# then odd and narrow widths (the mini models', and widths off the vector)
BN_ACT_WIDTHS = (32, 64, 128, 256, 512, 1024, 3, 5, 8, 24, 33, 40, 1000)


def _bn_params(c, gen, dev):
    return (0.5 * torch.randn(c, generator=gen)).to(dev), \
        (torch.rand(c, generator=gen) + 0.25).to(dev), \
        (1 + 0.2 * torch.randn(c, generator=gen)).to(dev), \
        (0.3 * torch.randn(c, generator=gen)).to(dev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", BN_ACT_WIDTHS)
def test_bn_act_kernel_matches_plain_on_card(card, dtype, c):
    """K7 against the unfused ops on the same card: every activation, with
    and without a residual, 2-D, 4-D and 5-D maps (the stacked corr_conv's),
    a misaligned map (the element path). bf16: at most one unit in the last
    place on any element (`chip_smoke.bn_act_ulps`; bit for bit on PyTorch
    2.11). fp32: within `chip_smoke.K7_FP32_ULPS` units of fp32 (a 4-D or
    5-D map's BatchNorm is cuDNN's there, whose shift rounds once more),
    a limit that the same output rounded through bf16 fails. The share of
    elements that differ and the largest gap in ulps are printed."""
    dt = getattr(torch, dtype)
    limit = 1.0 if dt == torch.bfloat16 else chip_smoke.K7_FP32_ULPS
    gen = torch.Generator().manual_seed(c)
    params = _bn_params(c, gen, card)
    differ, total, worst = 0, 0, 0.0
    kernels.reset_launches()
    calls = 0
    for shape in ((4 * 9 * 11, c), (4, 9, 11, c), (2, 3, 5, 4, c), "misaligned"):
        if shape == "misaligned":
            buf = (2 * torch.randn(1 + 3 * 7 * c, generator=gen)).to(card, dt)
            y = buf[1:].view(1, 3, 7, c)
            assert y.data_ptr() % 16 != 0
        else:
            y = (2 * torch.randn(shape, generator=gen)).to(card, dt)
        for act in ("leaky", "relu", None):
            for residual in (None, torch.randn(y.shape, generator=gen).to(card, dt)):
                with torch.no_grad():
                    got = k7.bn_act(y, *params, 1e-5, act, residual)
                    want = k7.bn_act_plain(y, *params, 1e-5, act, residual)
                calls += 1
                assert got.dtype == dt and got.shape == y.shape and got.is_contiguous()
                ulps = chip_smoke.bn_act_ulps(got, want, y, params, 1e-5, residual)
                assert ulps.max().item() <= limit, (shape, act, residual is not None)
                if dt == torch.float32:
                    rounded = got.to(torch.bfloat16).float()
                    assert chip_smoke.bn_act_ulps(rounded, want, y, params, 1e-5,
                                                  residual).max().item() > limit
                worst = max(worst, ulps.max().item())
                differ += (got != want).sum().item()
                total += want.numel()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bn_act"] == calls
    print(f"bn_act {dtype} C={c}: {differ} of {total} elements differ from the unfused "
          f"ops ({differ / total:.3g}), largest gap {worst} ulps of {dtype}")


def test_bn_act_kernel_at_tick_shapes_on_card(card):
    """K7 at the served tick's largest maps (120 frames, bf16): the first
    conv's 256 x 256 x 32 and a residual block's 128 x 128 x 64 with its
    shortcut, against the unfused ops."""
    gen = torch.Generator().manual_seed(1)
    for (h, c), res in (((256, 32), False), ((128, 64), True)):
        params = _bn_params(c, gen, card)
        y = torch.randn((120, h, h, c), device=card, dtype=torch.bfloat16)
        r = torch.randn_like(y) if res else None
        with torch.no_grad():
            got = k7.bn_act(y, *params, 1e-5, "leaky", r)
            want = k7.bn_act_plain(y, *params, 1e-5, "leaky", r)
        share = (got != want).float().mean().item()
        assert chip_smoke.bn_act_ulps(got, want, y, params, 1e-5, r).max().item() <= 1.0
        print(f"bn_act tick map {h}x{h}x{c} residual {res}: {share:.3g} of elements differ")


def test_bn_act_refuses_what_the_kernel_cannot_take(card):
    """On the card `bn_act` launches K7 or raises, never falls back to the
    unfused ops: fp16 maps, fp16 parameters, a BatchNorm without affine
    parameters, a residual of another dtype or shape, and a call that
    autograd records are refused before any launch."""
    gen = torch.Generator().manual_seed(2)
    params = _bn_params(16, gen, card)
    y = torch.randn((2, 3, 3, 16), generator=gen).to(card)
    kernels.reset_launches()
    bad = [((y.half(), *params), None), ((y, *(p.half() for p in params)), None),
           ((y, *params[:2], None, None), None), ((y, *params), y.bfloat16()),
           ((y, *params), y[:, :2].contiguous())]
    for args, residual in bad:
        with torch.no_grad(), pytest.raises(ValueError, match="takes y"):
            k7.bn_act(*args, 1e-5, "leaky", residual)
    with pytest.raises(ValueError, match="no backward"):
        k7.bn_act(y.requires_grad_(), *params, 1e-5, "leaky")
    assert kernels.LAUNCHES["bn_act"] == 0


# fp32 eval_clip with K7 against the unfused ops on the same card: the
# largest gap of any output over its largest magnitude. Each fp32 epilogue
# differs from cuDNN's BatchNorm by an ulp or two, which the convs after it
# carry on: this mini model reads 2.06e-6 on an H100 (PyTorch 2.11, the
# backbone's maps the largest), and the limit leaves about five times that.
# The same call with each epilogue rounded through bf16 reads 1.6e-2 and
# must fail it.
EVAL_CLIP_FP32_GAP = 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_clip_with_bn_act_equals_the_unfused_path(card, dtype, monkeypatch):
    """A mini model's eval_clip (its backbone, mapping, split corr_conv, and
    fcn epilogues on K7), against the same call with every epilogue on the
    unfused ops (`heads.bn_act` patched to `bn_act_plain`), and a residual
    backbone (`tests/test_torch_bn_act.py`'s cfg, shortcuts folded) in eval:
    bf16 bit for bit; fp32, where the unfused side's BatchNorm is cuDNN's,
    within EVAL_CLIP_FP32_GAP of each output's largest magnitude, a limit
    that the epilogues rounded through bf16 exceed. The gaps are printed."""
    from dcnet_tpu_torch.config import DCNetConfig
    from dcnet_tpu_torch.models import heads
    from dcnet_tpu_torch.models.darknet import DarknetBackbone, mini_backbone_defs
    from dcnet_tpu_torch.models.dcnet import DCNet
    from dcnet_tpu_torch.weights import seeded_init_
    from test_torch_bn_act import _residual_defs, _seeded_backbone

    cfg = DCNetConfig(image_size=64, corpus_size=50, emb_size=64, lstm_hidden=64,
                      word_embedding_size=64, compute_dtype=dtype)
    model = seeded_init_(DCNet(cfg, backbone_defs=mini_backbone_defs(), device=card), seed=0)
    bb = _seeded_backbone(_residual_defs()).to(card)
    assert isinstance(bb, DarknetBackbone)
    gen = torch.Generator().manual_seed(21)
    images = torch.rand(10, 64, 64, 3, generator=gen).to(card)
    ids = torch.randint(1, 50, (2, 20), generator=gen).to(card)
    dt = getattr(torch, dtype)
    # fp32 as the repository's fp32 paths run it: TF32 would round each
    # conv's input to 10 bits and turn a unit of fp32 into a unit of TF32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)

    def run():
        out = model.eval_clip(images, ids)
        with torch.no_grad():
            maps = bb(images[:4], dt)
        return [t for name in ("outbox", "corr_feat", "sim_score")
                for t in getattr(out, name)] + list(maps)

    kernels.reset_launches()
    got = run()
    launches = kernels.LAUNCHES["bn_act"]
    monkeypatch.setattr(heads, "bn_act", k7.bn_act_plain)
    want = run()
    torch.cuda.synchronize()
    assert launches == chip_smoke.bn_act_per_call(cfg, defs=mini_backbone_defs()) + 9
    assert kernels.LAUNCHES["bn_act"] == launches
    assert all(g.dtype == w.dtype for g, w in zip(got, want))

    def gap(outs):
        return max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
                   for g, w in zip(outs, want) if g.is_floating_point())

    if dt == torch.bfloat16:
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        print("eval_clip bfloat16: bit for bit the unfused path")
        return
    monkeypatch.setattr(heads, "bn_act", lambda *a: k7.bn_act(*a).to(torch.bfloat16).to(dt))
    rounded = run()
    print(f"eval_clip float32: largest gap to the unfused path {gap(got)} of the output's "
          f"magnitude, {gap(rounded)} with the epilogues rounded through bf16; by output "
          f"{[round(((g - w).abs().max()).item(), 9) for g, w in zip(got, want)]}")
    assert gap(got) <= EVAL_CLIP_FP32_GAP < gap(rounded)
