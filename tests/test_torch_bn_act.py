"""K7, the eval-mode conv epilogue (`dcnet_tpu_torch.kernels.bn_act`), on
the CPU, where it is the plain composition: BatchNorm on the running
statistics, the activation, then the shortcut add.

- `bn_act` and the `dcnet::bn_act` operator against the unfused ops, bit
  for bit, for fp32 and bf16, every activation, with and without a
  residual, on 4-D and 5-D maps; the operator's schema and fake
  implementation (`torch.library.opcheck`), and a meta tensor refused.
- The eval forwards that now end in it (`DarknetBackbone` with its
  shortcuts folded into the conv before them, `ConvBNReLU` plain, split
  and stacked, and in `calib` mode) against the forwards they replace, bit
  for bit; their training forwards run the same aten ops as before.
- Which shortcuts fold: a shortcut whose conv output something else reads
  keeps its own add.

The kernel itself runs only on a CUDA card (`tests/test_torch_cuda.py`).
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.kernels import bn_act as k7
from dcnet_tpu_torch.models import darknet, heads
from dcnet_tpu_torch.models.darknet import (
    DarknetBackbone, mini_backbone_defs, parse_darknet_cfg, yolov3_layer_defs)
from dcnet_tpu_torch.models.heads import ConvBNReLU

OPCHECK_TESTS = ("test_schema", "test_faketensor", "test_aot_dispatch_dynamic")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this file's processes: the suite runs files in
    parallel workers, where per-op thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bn(c, gen):
    bn = torch.nn.BatchNorm2d(c, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.2 * torch.randn(c, generator=gen))
        bn.bias.copy_(0.3 * torch.randn(c, generator=gen))
        bn.running_mean.copy_(0.5 * torch.randn(c, generator=gen))
        bn.running_var.copy_(torch.rand(c, generator=gen) + 0.25)
    return bn


def _unfused(y, bn, act, residual):
    """The ops the eval paths ran before K7, written out."""
    out = F.batch_norm(y.movedim(-1, 1), bn.running_mean, bn.running_var, bn.weight,
                       bn.bias, False, 0.0, bn.eps).movedim(1, -1)
    if act == "leaky":
        out = F.leaky_relu(out, torch.tensor(0.1, dtype=out.dtype).item())
    elif act == "relu":
        out = F.relu(out)
    return out if residual is None else out + residual


@pytest.mark.parametrize("residual", [False, True], ids=["no_residual", "residual"])
@pytest.mark.parametrize("act", ["leaky", "relu", None], ids=["leaky", "relu", "none"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_path_equals_the_unfused_composition(dtype, act, residual):
    dt = DTYPES[dtype]
    gen = torch.Generator().manual_seed(3)
    for shape in ((2, 5, 7, 24), (2, 3, 4, 4, 40), (6, 33)):
        bn = _bn(shape[-1], gen)
        y = (2 * torch.randn(shape, generator=gen)).to(dt)
        r = torch.randn(shape, generator=gen).to(dt) if residual else None
        want = _unfused(y, bn, act, r)
        args = (y, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps, act, r)
        with torch.no_grad():
            for got in (k7.bn_act(*args), torch.ops.dcnet.bn_act(*args),
                        heads.bn_eval_act(y, bn, act, r)):
                assert got.dtype == dt and got.shape == y.shape
                assert torch.equal(got, want), (shape, act)
        # and with autograd recording (the plain composition is differentiable)
        got = heads.bn_eval_act(y.float().requires_grad_(), bn, act,
                                None if r is None else r.float())
        assert got.requires_grad and torch.equal(
            got.detach(), _unfused(y.float(), bn, act, None if r is None else r.float()))


def test_bn_act_takes_the_plain_composition_off_the_card():
    """CPU tensors take the plain composition: the kernel is never asked,
    and no launch is counted. Any other device goes to the kernel or is
    refused, never quietly to the plain ops: a meta map raises."""
    gen = torch.Generator().manual_seed(4)
    bn = _bn(16, gen)
    y = torch.randn(2, 3, 3, 16, generator=gen)
    params = (bn.running_mean, bn.running_var, bn.weight, bn.bias)
    kernels.reset_launches()
    heads.bn_eval_act(y, bn, "leaky")
    assert kernels.LAUNCHES["bn_act"] == 0
    with pytest.raises(ValueError, match="act"):
        k7.bn_act(y, *params, bn.eps, "gelu")
    with pytest.raises(ValueError, match="CUDA device"):
        k7.bn_act(y.to("meta"), *(p.to("meta") for p in params), bn.eps, "leaky")
    assert kernels.LAUNCHES["bn_act"] == 0


@pytest.mark.parametrize("case", ["bf16_leaky_residual", "fp32_relu", "bf16_none_5d"])
def test_bn_act_op_passes_opcheck(case):
    gen = torch.Generator().manual_seed(5)
    dt = torch.float32 if case.startswith("fp32") else torch.bfloat16
    shape = (2, 3, 2, 2, 8) if case.endswith("5d") else (2, 4, 4, 8)
    bn = _bn(8, gen)
    y = torch.randn(shape, generator=gen).to(dt)
    r = torch.randn(shape, generator=gen).to(dt) if "residual" in case else None
    act = next((a for a in ("leaky", "relu") if a in case), None)
    args = (y, bn.running_mean.detach(), bn.running_var.detach(), bn.weight.detach(),
            bn.bias.detach(), bn.eps, act, r)
    torch.library.opcheck(torch.ops.dcnet.bn_act.default, args, test_utils=OPCHECK_TESTS)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fake_gives_shape_and_dtype_and_meta_is_refused(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    dt = DTYPES[dtype]
    with FakeTensorMode():
        y = torch.empty((3, 5, 6, 40), dtype=dt)
        r = torch.empty((3, 5, 6, 40), dtype=dt)
        p = [torch.empty(40) for _ in range(4)]
        out = torch.ops.dcnet.bn_act(y, *p, 1e-5, "leaky", r)
        assert out.shape == y.shape and out.dtype == dt and out.is_contiguous()
        out = torch.ops.dcnet.bn_act(y[:, :, ::2], *p, 1e-5, None, None)
        assert out.shape == (3, 5, 3, 40) and out.is_contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        torch.ops.dcnet.bn_act(torch.zeros((2, 3, 8), dtype=dt, device="meta"),
                               *[torch.zeros(8, device="meta")] * 4, 1e-5, None, None)


# --------------------------------------------------------------------------
# The eval forwards that end in it
# --------------------------------------------------------------------------

RESIDUAL_CFG = """
[net]
channels=3

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-3
activation=linear

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=linear

[shortcut]
from=-2
activation=linear

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-2
activation=linear

[route]
layers=-2

[convolutional]
batch_normalize=1
filters=24
size=3
stride=2
pad=1
activation=leaky

[yoloconvolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers=-1, 7

[yoloconvolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=0
filters=6
size=1
stride=1
pad=1
activation=linear

[yoloconvolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky
"""


# shortcuts that follow a folded conv's shortcut at once (layer 3) or after
# a maxpool (layer 7): each adds on its own
CHAINED_SHORTCUT_CFG = """
[net]
channels=3

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-2
activation=linear

[shortcut]
from=-3
activation=linear

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky

[shortcut]
from=-2
activation=linear

[maxpool]
size=2
stride=1

[shortcut]
from=-2
activation=linear

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=linear

[shortcut]
from=-2
activation=linear

[yoloconvolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky
"""


def _residual_defs():
    return parse_darknet_cfg(RESIDUAL_CFG)[1]


def _seeded_backbone(defs, seed=0):
    gen = torch.Generator().manual_seed(seed)
    bb = DarknetBackbone(defs)
    with torch.no_grad():
        for i, ld in enumerate(defs):
            if ld.type not in ("convolutional", "yoloconvolutional"):
                continue
            conv = bb.module_list[i][0]
            conv.weight.copy_(0.3 * torch.randn(conv.weight.shape, generator=gen))
            if conv.bias is not None:
                conv.bias.copy_(0.1 * torch.randn(conv.bias.shape, generator=gen))
            if ld.batch_normalize:
                bb.module_list[i][1].load_state_dict(
                    _bn(ld.filters, gen).state_dict())
    return bb


def _unfused_backbone(bb, x, dtype, train):
    """`DarknetBackbone.forward` as it ran before K7."""
    captured, saved = [], {}
    x = x.to(dtype)
    for i, ld in enumerate(bb.layer_defs):
        if ld.type in ("convolutional", "yoloconvolutional"):
            if ld.type == "yoloconvolutional":
                captured.append(x)
            conv = bb.module_list[i][0]
            x = heads.conv_nhwc(x, conv.weight, conv.bias, ld.stride, ld.pad)
            if ld.batch_normalize:
                x = heads.batch_norm(x, bb.module_list[i][1], train)
            if ld.activation == "leaky":
                x = heads.leaky_relu(x)
        elif ld.type == "maxpool":
            x = darknet._max_pool_nhwc(x, ld.size, ld.stride)
        elif ld.type == "upsample":
            x = darknet.upsample2(x)
        elif ld.type == "route":
            x = torch.cat([saved[s if s >= 0 else i + s] for s in ld.layers], dim=-1)
        elif ld.type == "shortcut":
            s = ld.from_
            x = x + saved[s if s >= 0 else i + s]
        if i in bb._keep:
            saved[i] = x
    return captured


class _AtenOps(TorchDispatchMode):
    """The aten ops a call dispatches, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_folded_shortcuts():
    """YOLOv3 folds each of its 23 residual blocks' adds into the 3x3 conv
    before them; the test cfg folds the shortcuts at 3 and 5, and not the
    one at 7, whose conv (6) a route reads."""
    defs = yolov3_layer_defs()
    fold = darknet._folded_shortcuts(defs, darknet._referenced_outputs(defs))
    assert len(fold) == 23 and sum(ld.type == "shortcut" for ld in defs) == 23
    assert all(defs[i + 1].type == "shortcut" and defs[i].size == 3 for i in fold)
    defs = _residual_defs()
    assert darknet._folded_shortcuts(defs, darknet._referenced_outputs(defs)) == {2: 0, 4: 3}
    assert not darknet._folded_shortcuts(mini_backbone_defs(), set())


@pytest.mark.parametrize("defs", ["residual", "mini"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_backbone_eval_equals_the_unfused_forward(defs, dtype):
    """The eval forward, shortcuts folded, gives the unfused forward's maps
    bit for bit; the folded calls pass the residual, the others none."""
    dt = DTYPES[dtype]
    d = _residual_defs() if defs == "residual" else mini_backbone_defs()
    bb = _seeded_backbone(d)
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    calls = []
    orig = darknet.bn_eval_act

    def spy(y, bn, act, residual=None):
        calls.append((act, residual is not None))
        return orig(y, bn, act, residual)

    darknet.bn_eval_act = spy
    try:
        with torch.no_grad():
            got = bb(x, dt)
    finally:
        darknet.bn_eval_act = orig
    with torch.no_grad():
        want = _unfused_backbone(bb, x, dt, False)
    assert len(got) == len(want) == 3
    assert all(g.dtype == dt and torch.equal(g, w) for g, w in zip(got, want))
    n_bn = sum(ld.batch_normalize for ld in d if ld.type in ("convolutional",
                                                                "yoloconvolutional"))
    assert len(calls) == n_bn
    assert sum(r for _, r in calls) == (2 if defs == "residual" else 0)
    if defs == "residual":  # the linear conv 4 folds with no activation
        assert calls[3] == (None, True) and calls[2] == ("leaky", True)


def test_unfolded_shortcut_keeps_its_own_add():
    """A shortcut after a conv whose output a route reads (layers 6, 7, 8)
    adds on its own: the conv's pre-add output reaches the route."""
    d = _residual_defs()
    bb = _seeded_backbone(d, seed=2)
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(5))
    seen = {}
    orig = darknet.bn_eval_act

    def spy(y, bn, act, residual=None):
        seen[bn] = residual is not None
        return orig(y, bn, act, residual)

    darknet.bn_eval_act = spy
    try:
        with torch.no_grad():
            got = bb(x)
    finally:
        darknet.bn_eval_act = orig
    assert seen[bb.module_list[4][1]] and not seen[bb.module_list[6][1]]
    with torch.no_grad():
        want = _unfused_backbone(bb, x, torch.float32, False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chained_shortcuts_after_a_folded_conv_each_add(dtype, train):
    """A shortcut right after a folded conv's shortcut, or after a maxpool
    that follows one, still adds its own input: the forward gives the
    unfused forward's map bit for bit, in eval and in training."""
    dt = DTYPES[dtype]
    defs = parse_darknet_cfg(CHAINED_SHORTCUT_CFG)[1]
    bb = _seeded_backbone(defs, seed=6)
    assert bb._fold == {1: 0, 4: 3, 8: 7}
    x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        got = bb(x, dt, train=train)
    with torch.no_grad():
        want = _unfused_backbone(_seeded_backbone(defs, seed=6), x, dt, train)
    assert len(got) == len(want) == 1
    assert got[0].dtype == dt and torch.equal(got[0], want[0])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_backbone_training_runs_the_same_ops(dtype):
    """In training the forward runs the aten ops it ran before K7, one for
    one, and gives the same maps and running statistics."""
    dt = DTYPES[dtype]
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(7))
    results = []
    for fn in (lambda bb: bb(x, dt, train=True),
               lambda bb: _unfused_backbone(bb, x, dt, True)):
        bb = _seeded_backbone(_residual_defs(), seed=3)
        with _AtenOps() as mode:
            out = fn(bb)
        results.append((mode.ops, out, {k: v.clone() for k, v in bb.state_dict().items()}))
    (ops, out, sd), (ops0, out0, sd0) = results
    assert ops == ops0
    assert "aten.add.Tensor" in ops
    assert all(torch.equal(a, b) for a, b in zip(out, out0))
    assert all(torch.equal(sd[k], sd0[k]) for k in sd0)


def _cbr(dtype, leaky, relu, quant="off", seed=0):
    gen = torch.Generator().manual_seed(seed)
    m = ConvBNReLU(24, 16, 1, leaky=leaky, relu=relu, dtype=dtype, quant=quant)
    with torch.no_grad():
        m.conv.weight.copy_(0.3 * torch.randn(m.conv.weight.shape, generator=gen))
        m.bn.load_state_dict(_bn(16, gen).state_dict())
    return m


def _unfused_cbr(m, x, train=False):
    """`ConvBNReLU`'s float forward as it ran before K7."""
    def act(y):
        if m.leaky:
            return heads.leaky_relu(y)
        return F.relu(y) if m.relu else y

    if isinstance(x, tuple):
        shared, parts = x
        w = m.conv.weight.to(m.dtype).flatten(1)
        c_s = shared.shape[-1]
        y_s = F.linear(shared.to(m.dtype), w[:, :c_s])
        if isinstance(parts, torch.Tensor):
            return act(heads.bn_eval(y_s[:, None] + F.linear(parts.to(m.dtype), w[:, c_s:]),
                                     m.bn))
        return [act(heads.bn_eval(y_s + F.linear(p.to(m.dtype), w[:, c_s:]), m.bn))
                for p in parts]
    y = heads.conv_nhwc(x.to(m.dtype), m.conv.weight, None, m.conv.stride[0],
                        m.conv.padding[0])
    return act(heads.batch_norm(y, m.bn, train))


@pytest.mark.parametrize("act", ["leaky", "relu", "none"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv_bn_relu_eval_equals_the_unfused_forward(dtype, act):
    """Plain, split-list and stacked inputs, and `calib` mode (which also
    records the same act_max), bit for bit."""
    dt = DTYPES[dtype]
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(2, 6, 6, 24, generator=gen)
    shared = torch.randn(2, 6, 6, 12, generator=gen)
    parts = [torch.randn(2, 6, 6, 12, generator=gen) for _ in range(3)]
    cases = [x, (shared, parts), (shared, torch.stack(parts, dim=1))]
    for quant in ("off", "calib"):
        m = _cbr(dt, act == "leaky", act == "relu", quant)
        ref = _cbr(dt, act == "leaky", act == "relu")
        with torch.no_grad():
            for inp in cases:
                got, want = m(inp), _unfused_cbr(ref, inp)
                if isinstance(want, list):
                    assert len(got) == len(want)
                    assert all(torch.equal(g, w) for g, w in zip(got, want))
                else:
                    assert got.dtype == dt and torch.equal(got, want)
        if quant == "calib":
            assert m.act_max.item() == max(t.abs().max().item()
                                           for t in (x, shared, *parts))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv_bn_relu_training_runs_the_same_ops(dtype):
    dt = DTYPES[dtype]
    x = torch.randn(4, 5, 5, 24, generator=torch.Generator().manual_seed(12))
    results = []
    for fn in (lambda m: m(x, train=True), lambda m: _unfused_cbr(m, x, train=True)):
        m = _cbr(dt, True, False, seed=4)
        with _AtenOps() as mode:
            out = fn(m)
        results.append((mode.ops, out, m.bn.running_var.clone()))
    assert results[0][0] == results[1][0]
    assert torch.equal(results[0][1], results[1][1])
    assert torch.equal(results[0][2], results[1][2])
