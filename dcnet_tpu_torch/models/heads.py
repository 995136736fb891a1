"""Fusion-head building blocks (PyTorch, NHWC at the boundary).

The port of `dcnet_tpu/models/heads.py`: `l2_normalize`, ConvBNReLU (with
the split input that computes the shared center half of corr_conv once),
DenseBNReLU (with the exact rank-8 `gram_factors` path), MappingLang, the
per-scale fusion FCN + box head, and `tile_language`. Children carry the
reference names (`conv`/`bn`, `0`/`1` of a Linear+BatchNorm1d pair), so the
reference state_dict loads as it is. BN math runs in fp32 and activations
are stored in the module's compute dtype, as in the JAX package; each
forward takes `train`, which normalises with batch statistics and moves the
running ones with flax's rule (`bn_train`) and turns dropout on. ConvBNReLU
carries the static-scale int8 modes of the JAX package's QuantConv2D
(`quant`: "calib" records its input's abs-max, "int8" runs kernel K6).
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from dcnet_tpu_torch.config import ANCHORS_PER_SCALE, BOX_ATTRS
from dcnet_tpu_torch.kernels.conv_s8 import conv_s8
from dcnet_tpu_torch.parallel import mesh


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(p=2) that clamps the *squared* norm before rsqrt (an
    all-zero slice maps to zero, with a zero gradient)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], stride: int = 1,
              pad: int = 0) -> torch.Tensor:
    """Convolution of an NHWC map with an (O, I, kh, kw) kernel, in x's
    dtype. A 1x1/stride-1 conv is the matmul it is over the channels-last
    layout; others run on the channels-last NCHW view. Returns NHWC."""
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if w.shape[2] == w.shape[3] == 1 and stride == 1 and pad == 0:
        return F.linear(x, w.flatten(1), b)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride, pad).permute(0, 2, 3, 1)
    return y if y.is_contiguous() else y.contiguous()


def bn_eval(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """Inference BatchNorm over the last axis on the running statistics.
    The math runs in fp32 (the parameters' type) and the result is stored
    in x's dtype, in one pass: a bf16 map is read and written once."""
    y = F.batch_norm(x.movedim(-1, 1), bn.running_mean, bn.running_var,
                     bn.weight, bn.bias, False, 0.0, bn.eps)
    return y.movedim(1, -1)


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module):
    """Inside it `bn_train` leaves the running statistics of `module`'s
    BatchNorms as they are: the backbone's recompute under
    `remat_backbone` runs the forward a second time, and one step must
    move them once, as flax's `nn.remat` does. A flag on each BatchNorm,
    not on the thread: autograd may recompute on its own thread."""
    bns = [m for m in module.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for bn in bns:
        bn.stats_frozen = True
    try:
        yield
    finally:
        for bn in bns:
            bn.stats_frozen = False


def bn_train(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """Training BatchNorm over the last axis: normalises with the batch
    mean and the *biased* batch variance (fp32 math, output in x's dtype),
    differentiable, and moves the running statistics as flax does:
    stat = (1 - m) stat + m batch_stat with the module's torch momentum m
    and the biased variance. (`F.batch_norm(training=True)` would store the
    unbiased variance, n/(n-1) times flax's.)

    On a CUDA card the fused kernel (`native_batch_norm`, Welford
    statistics, one pass each way) normalises, and the variance comes back
    from its saved 1/sqrt(var + eps). On the CPU that kernel sums its
    statistics in plain fp32 order, which at 256 px (2^18 values a channel)
    is 1e-5 to 1e-4 off and depends on the thread count; 75 train-mode
    BatchNorms amplify that into 1e-2 of the backbone's gradient. So the CPU
    takes the statistics from `torch.var_mean` (cascade sums, ~1e-7) and
    normalises with the same formula as flax, (x - mean) (rsqrt(var + eps)
    scale) + bias.

    Under data parallelism (`parallel.mesh.bn_group(bn)`: a process group of
    more than one rank) the moments are the global batch's, as in the JAX
    package's step jitted over a sharded batch: each rank's count and
    channel sums are all-reduced for the mean, then the sums of squared
    deviations for the variance, both differentiable (their backward is
    the matching all-reduce), and every rank moves the running statistics
    by the same global moments. Without a group, or with one of one rank,
    the code below runs as it is."""
    group = mesh.bn_group(bn)
    if group is not None:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = tuple(range(x.dim() - 1))
        part = torch.cat([x32.sum(dims), x32.new_full((1,), x32.numel() // x.shape[-1])])
        total = mesh.all_reduce_sum(part, group)
        mean = total[:-1] / total[-1]
        dev = x32 - mean
        var = mesh.all_reduce_sum((dev * dev).sum(dims), group) / total[-1]
        y = (dev * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias).to(x.dtype)
        mean, var = mean.detach(), var.detach().double()
    elif x.device.type == "cpu":
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        var, mean = torch.var_mean(x32, dim=tuple(range(x.dim() - 1)),
                                   correction=0)
        y = ((x32 - mean) * (torch.rsqrt(var + bn.eps) * bn.weight)
             + bn.bias).to(x.dtype)
        mean, var = mean.detach(), var.detach().double()
    else:
        y, mean, invstd = torch.native_batch_norm(
            x.movedim(-1, 1), bn.weight, bn.bias, None, None, True, 0.0, bn.eps)
        y = y.movedim(1, -1)
        var = torch.clamp(invstd.detach().double().pow(-2) - bn.eps, min=0.0)
    if getattr(bn, "stats_frozen", False):
        return y
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean.to(bn.running_mean.dtype), alpha=m)
        bn.running_var.mul_(1 - m).add_(var.to(bn.running_var.dtype), alpha=m)
        bn.num_batches_tracked.add_(1)
    return y


def batch_norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm,
               train: bool) -> torch.Tensor:
    return bn_train(x, bn) if train else bn_eval(x, bn)


def dropout(x: torch.Tensor, p: float, train: bool) -> torch.Tensor:
    """Inverted dropout in training only (torch's global generator)."""
    return F.dropout(x, p, training=True) if train and p > 0 else x


@functools.lru_cache(maxsize=None)
def _slope(dtype: torch.dtype) -> float:
    return torch.tensor(0.1, dtype=dtype).item()


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.1) with the slope rounded to x's dtype first, as JAX
    applies a Python-float slope to a bf16 array (0.1 -> 0.10009765625),
    so bf16 activations round as the JAX package's do."""
    return F.leaky_relu(x, _slope(x.dtype))


def _act(y: torch.Tensor, leaky: bool, relu: bool) -> torch.Tensor:
    if leaky:
        return leaky_relu(y)
    return F.relu(y) if relu else y


class ConvBNReLU(nn.Module):
    """Conv (no bias) -> BN(eps 1e-5) -> ReLU / LeakyReLU(0.1), NHWC.

    Split input `(shared, [part_0, ..., part_{R-1}])` (1x1 only) evaluates
    the conv on the R concatenations [shared, part_r] while contracting the
    shared half once: W @ concat(s, p) = W_s @ s + W_p @ p. The kernel keeps
    its single concat shape, so checkpoints are unaffected. Returns a list
    of R outputs for a split input, or one stacked (B, R, H, W, F) output
    when the parts come stacked as one (B, R, H, W, C) tensor (eval BN and
    the activation act per channel, whatever the rank).

    `quant` (cfg.trunk_quant, eval only) is the JAX package's QuantConv2D
    mode: "calib" runs the float path and raises `act_max`, the running
    abs-max of every input piece; "int8" quantises the weights per output
    channel (s_w = max|w| / 127) and the input per tensor with the static
    scale s_in = act_max / 127, sums in int32 (kernel K6) and dequantises
    by s_in s_w into the BatchNorm. `act_max` is a buffer outside the
    state_dict, as the JAX package keeps it outside `params`."""

    def __init__(self, in_ch: int, features: int, kernel: int = 1,
                 stride: int = 1, leaky: bool = False, relu: bool = True,
                 dtype: torch.dtype = torch.float32, quant: str = "off",
                 device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride,
                              (kernel - 1) // 2, bias=False, device=device)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.999,
                                 device=device)
        self.leaky, self.relu, self.dtype = leaky, relu, dtype
        self.quant = quant
        self.register_buffer("act_max", torch.zeros((), device=device),
                             persistent=False)
        self._int8_cache = None   # (stamp, pinned sources, constants): _int8_consts

    def forward(self, x: Union[torch.Tensor, Tuple[torch.Tensor, Sequence[torch.Tensor]]],
                train: bool = False) -> Union[torch.Tensor, List[torch.Tensor]]:
        """`train` normalises with batch statistics and moves the running
        ones (`bn_train`) and runs in float; the split input is eval-only."""
        split = isinstance(x, tuple)
        if split:
            if train:
                raise ValueError("split-input ConvBNReLU is an eval-path "
                                 "optimization")
            if self.conv.kernel_size != (1, 1) or self.conv.stride != (1, 1):
                raise ValueError("split-input ConvBNReLU is 1x1/stride-1 only")
        mode = "off" if train else self.quant
        if mode == "calib":
            self._record(x)
        elif mode == "int8":
            return self._int8(x)
        if split:
            shared, parts = x
            w = self.conv.weight.to(self.dtype).flatten(1)
            c_s = shared.shape[-1]
            y_s = F.linear(shared.to(self.dtype), w[:, :c_s])
            if isinstance(parts, torch.Tensor):  # stacked (B, R, H, W, C)
                y = y_s[:, None] + F.linear(parts.to(self.dtype), w[:, c_s:])
                return _act(bn_eval(y, self.bn), self.leaky, self.relu)
            return [_act(bn_eval(y_s + F.linear(p.to(self.dtype), w[:, c_s:]),
                             self.bn), self.leaky, self.relu)
                    for p in parts]
        y = conv_nhwc(x.to(self.dtype), self.conv.weight, None,
                      self.conv.stride[0], self.conv.padding[0])
        return _act(batch_norm(y, self.bn, train), self.leaky, self.relu)

    @torch.no_grad()
    def _record(self, x) -> None:
        """act_max = max(act_max, max |piece|) over the input's pieces."""
        if isinstance(x, tuple):
            shared, parts = x
            pieces = [shared, parts] if isinstance(parts, torch.Tensor) \
                else [shared, *parts]
        else:
            pieces = [x]
        m = torch.stack([p.float().abs().amax() for p in pieces]).amax()
        self.act_max.copy_(torch.maximum(self.act_max, m))

    def _int8_consts(self, c_s: Optional[int] = None):
        """The int8 mode's constants, with the JAX package's arithmetic: s_w,
        s_in and the weight quantisation in fp32 with true divisions (by
        device tensors: CUDA divides by a host scalar as a multiply by its
        reciprocal); the weights in K6's (O, k, k, I) layout, and split at
        `c_s` input channels for the split input; the epilogue's vectors.
        They are made once and kept until the weights, the BatchNorm
        statistics or act_max change: each source's storage and version
        counter stamp the cache, which pins the sources, so no storage
        address is reused while it is cached. Under `torch.export` the
        cache filled before the trace is read as it is (the program's
        constants)."""
        bn = self.bn
        if torch.compiler.is_compiling():  # under torch.export: the cache is a constant
            if self._int8_cache is None:
                raise RuntimeError("the int8 trunk's constants are made by a call "
                                   "before the trace (export_engine's warm-up tick)")
            return self._int8_cache[2]
        srcs = (self.conv.weight, bn.weight, bn.bias, bn.running_mean,
                bn.running_var, self.act_max)
        stamp = None if any(t.is_inference() for t in srcs) else \
            tuple((t.data_ptr(), t._version) for t in srcs)
        cache = self._int8_cache
        if stamp is None or cache is None or cache[0] != stamp:
            dev = self.conv.weight.device
            w32 = self.conv.weight.float()
            s_w = torch.clamp(w32.abs().amax(dim=(1, 2, 3)), min=1e-12) / \
                torch.tensor(127.0, device=dev)
            s_in = torch.clamp(self.act_max, min=1e-12) / torch.tensor(127.0, device=dev)
            wq = torch.clamp(torch.round(w32 / s_w[:, None, None, None]), -127, 127
                             ).to(torch.int8).permute(0, 2, 3, 1).contiguous()  # (O, k, k, I)
            mul = ((1.0 / (bn.running_var.float() + bn.eps).double().sqrt()).float()
                   * bn.weight.float())
            epi = dict(scale=s_in * s_w, bias=-bn.running_mean.float(), scale2=mul,
                       bias2=bn.bias.float(),
                       act="leaky" if self.leaky else ("relu" if self.relu else None),
                       out_dtype=self.dtype, in_scale=s_in)
            cache = (stamp, tuple(t.detach() for t in srcs), {"wq": wq, "epi": epi})
            self._int8_cache = None if stamp is None else cache
        consts = cache[2]
        if c_s is not None and c_s not in consts:
            wq = consts["wq"]
            consts[c_s] = (wq[..., :c_s].contiguous(), wq[..., c_s:].contiguous())
        return consts

    @torch.no_grad()
    def _int8(self, x):
        """The int8 mode on the constants of `_int8_consts`: K6 quantizes
        the input as it gathers it, clamp(round(x / s_in)), sums in int32,
        then in its epilogue dequantises and applies the BatchNorm as XLA's
        CPU backend contracts `acc * (s_in s_w)` -> `(y - mean) * mul +
        beta`: fma(acc, s, -mean), then fma(., mul, beta); ReLU / leaky;
        the compute dtype. The split input quantises both halves with the
        one (concat-calibrated) scale and adds the shared half's int32 sums
        in the epilogue."""
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"the int8 trunk writes float32 or bfloat16, not {self.dtype}")
        if self.leaky and self.dtype != torch.float32:
            raise ValueError("the int8 trunk's leaky activation runs in fp32 only")
        if not isinstance(x, tuple):
            consts = self._int8_consts()
            return conv_s8(x.contiguous(), consts["wq"], self.conv.stride[0],
                           self.conv.padding[0], **consts["epi"])
        shared, parts = x
        c_s = shared.shape[-1]
        consts = self._int8_consts(c_s)
        epi, (w_s, w_p) = consts["epi"], consts[c_s]
        y_s = conv_s8(shared.contiguous(), w_s, in_scale=epi["in_scale"])  # int32 (B, H, W, F)
        hw = shared.shape[1] * shared.shape[2]
        if isinstance(parts, torch.Tensor):  # stacked (B, R, H, W, C)
            b, r = parts.shape[:2]
            y = conv_s8(parts.reshape(b * r, *parts.shape[2:]).contiguous(),
                        w_p, addend=y_s, addend_hw=hw, addend_rep=r, **epi)
            return y.reshape(b, r, *y.shape[1:])
        return [conv_s8(p.contiguous(), w_p, addend=y_s, addend_hw=hw, **epi)
                for p in parts]


class DenseBNReLU(nn.Sequential):
    """Linear -> BatchNorm1d -> ReLU, children `0`, `1`, `2`."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(nn.Linear(in_features, features, device=device),
                         nn.BatchNorm1d(features, eps=1e-5, device=device),
                         nn.ReLU())
        self.dtype = dtype

    def forward(self, x: Optional[torch.Tensor],
                gram_factors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                train: bool = False) -> torch.Tensor:
        """ReLU(BN(x W + b)). With gram_factors=(ce (B,P,E), obj (B,P)) it
        computes ReLU(BN((ce ceᵀ diag(obj)) W + b)) without the (P, P) Gram:
        ce ceᵀ has rank <= E, so (ce ceᵀ diag(obj)) W = ce (ceᵀ (obj ∘ W)),
        exact. `x` is ignored there; the output is (B*P, C). `train` takes
        the batch statistics (`bn_train`)."""
        lin = self[0]
        w = lin.weight.to(self.dtype)
        b = lin.bias.to(self.dtype)
        if gram_factors is None:
            y = F.linear(x.to(self.dtype), w, b)
        else:
            ce, obj = gram_factors
            a = ce.transpose(1, 2) * obj[:, None, :]           # (B, E, P)
            h = F.linear(a.to(self.dtype), w, b)                # ceᵀ(obj∘W) + b
            y = (torch.einsum("bpe,bec->bpc", ce.to(self.dtype), h - b) + b
                 ).reshape(-1, w.shape[0])
        return F.relu(batch_norm(y, self[1], train))


class MappingLang(nn.Sequential):
    """textdim -> emb -> emb MLP: children 0 Linear, 1 BN, 2 ReLU,
    3 Dropout, 4 Linear, 5 BN, 6 ReLU (the reference's indices)."""

    def __init__(self, textdim: int, emb_size: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(
            nn.Linear(textdim, emb_size, device=device),
            nn.BatchNorm1d(emb_size, device=device), nn.ReLU(),
            nn.Dropout(dropout),
            nn.Linear(emb_size, emb_size, device=device),
            nn.BatchNorm1d(emb_size, device=device), nn.ReLU())
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """`train`: batch statistics, and dropout between the two layers."""
        for lin, bn in ((self[0], self[1]), (self[4], self[5])):
            if lin is self[4]:
                x = dropout(x, self[3].p, train)
            x = F.linear(x.to(self.dtype), lin.weight.to(self.dtype),
                         lin.bias.to(self.dtype))
            x = F.relu(batch_norm(x, bn, train))
        return x


def build_fusion_fcn(in_ch: int, emb_size: int, light: bool = False,
                     dtype: torch.dtype = torch.float32, quant: str = "off",
                     device=None) -> Tuple[nn.Sequential, nn.Sequential]:
    """One scale's (fcn_emb, fcn_out) pair in the reference layout.
    full: emb = 1x1, 3x3, 1x1 ConvBNReLU; out = 1x1 ConvBNReLU (emb->emb/2)
    + plain 1x1 conv to 15 channels. light: emb = one 1x1 ConvBNReLU;
    out = the plain 1x1 conv. `quant` is every ConvBNReLU's int8 mode (the
    plain head conv stays float, as in the JAX package)."""
    def cbr(i, o, k):
        return ConvBNReLU(i, o, k, dtype=dtype, quant=quant, device=device)

    n_out = ANCHORS_PER_SCALE * BOX_ATTRS
    if light:
        return (nn.Sequential(cbr(in_ch, emb_size, 1)),
                nn.Sequential(nn.Conv2d(emb_size, n_out, 1, device=device)))
    return (nn.Sequential(cbr(in_ch, emb_size, 1), cbr(emb_size, emb_size, 3),
                          cbr(emb_size, emb_size, 1)),
            nn.Sequential(cbr(emb_size, emb_size // 2, 1),
                          nn.Conv2d(emb_size // 2, n_out, 1, device=device)))


def fusion_fcn(fcn_emb: nn.Sequential, fcn_out: nn.Sequential,
               x: torch.Tensor, dtype: torch.dtype, train: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-scale fusion trunk + box head on an NHWC map. Returns
    (intermediate NHWC features, outbox (B, 3, 5, h, w))."""
    for m in fcn_emb:
        x = m(x, train=train)
    intmd = x
    for m in fcn_out[:-1]:
        x = m(x, train=train)
    head = fcn_out[-1]
    x = conv_nhwc(x.to(dtype), head.weight, head.bias)
    b, h, w, _ = x.shape
    outbox = x.reshape(b, h, w, ANCHORS_PER_SCALE, BOX_ATTRS)
    return intmd, outbox.permute(0, 3, 4, 1, 2)  # (B, 3, 5, h, w)


def tile_language(flang: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C) -> (B, h, w, C) broadcast view."""
    return flang[:, None, None, :].expand(flang.shape[0], h, w, flang.shape[1])
