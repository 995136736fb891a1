"""Fusion-head building blocks (PyTorch, NHWC at the boundary).

The port of `dcnet_tpu/models/heads.py`: `l2_normalize`, ConvBNReLU (with
the split input that computes the shared center half of corr_conv once),
DenseBNReLU (with the exact rank-8 `gram_factors` path), MappingLang, the
per-scale fusion FCN + box head, and `tile_language`. Children carry the
reference names (`conv`/`bn`, `0`/`1` of a Linear+BatchNorm1d pair), so the
reference state_dict loads as it is. BN math runs in fp32 on the running
statistics and activations are stored in the module's compute dtype, as in
the JAX package. The int8 QuantConv2D modes are not ported yet (ROADMAP
queue A, item 9).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from dcnet_tpu_torch.config import ANCHORS_PER_SCALE, BOX_ATTRS


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
    of R outputs for a split input."""

    def __init__(self, in_ch: int, features: int, kernel: int = 1,
                 stride: int = 1, leaky: bool = False, relu: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride,
                              (kernel - 1) // 2, bias=False, device=device)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.999,
                                 device=device)
        self.leaky, self.relu, self.dtype = leaky, relu, dtype

    def _finish(self, y: torch.Tensor) -> torch.Tensor:
        return _act(bn_eval(y, self.bn), self.leaky, self.relu)

    def forward(self, x: Union[torch.Tensor, Tuple[torch.Tensor, Sequence[torch.Tensor]]]
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        if isinstance(x, tuple):
            shared, parts = x
            if self.conv.kernel_size != (1, 1) or self.conv.stride != (1, 1):
                raise ValueError("split-input ConvBNReLU is 1x1/stride-1 only")
            w = self.conv.weight.to(self.dtype).flatten(1)
            c_s = shared.shape[-1]
            y_s = F.linear(shared.to(self.dtype), w[:, :c_s])
            return [self._finish(y_s + F.linear(p.to(self.dtype), w[:, c_s:]))
                    for p in parts]
        y = conv_nhwc(x.to(self.dtype), self.conv.weight, None,
                      self.conv.stride[0], self.conv.padding[0])
        return self._finish(y)


class DenseBNReLU(nn.Sequential):
    """Linear -> BatchNorm1d -> ReLU, children `0`, `1`, `2`."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(nn.Linear(in_features, features, device=device),
                         nn.BatchNorm1d(features, eps=1e-5, device=device),
                         nn.ReLU())
        self.dtype = dtype

    def forward(self, x: Optional[torch.Tensor],
                gram_factors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """ReLU(BN(x W + b)). With gram_factors=(ce (B,P,E), obj (B,P)) it
        computes ReLU(BN((ce ceᵀ diag(obj)) W + b)) without the (P, P) Gram:
        ce ceᵀ has rank <= E, so (ce ceᵀ diag(obj)) W = ce (ceᵀ (obj ∘ W)),
        exact. `x` is ignored there; the output is (B*P, C)."""
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
        return F.relu(bn_eval(y, self[1]))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin, bn in ((self[0], self[1]), (self[4], self[5])):
            x = F.linear(x.to(self.dtype), lin.weight.to(self.dtype),
                         lin.bias.to(self.dtype))
            x = F.relu(bn_eval(x, bn))
        return x


def build_fusion_fcn(in_ch: int, emb_size: int, light: bool = False,
                     dtype: torch.dtype = torch.float32, device=None
                     ) -> Tuple[nn.Sequential, nn.Sequential]:
    """One scale's (fcn_emb, fcn_out) pair in the reference layout.
    full: emb = 1x1, 3x3, 1x1 ConvBNReLU; out = 1x1 ConvBNReLU (emb->emb/2)
    + plain 1x1 conv to 15 channels. light: emb = one 1x1 ConvBNReLU;
    out = the plain 1x1 conv."""
    def cbr(i, o, k):
        return ConvBNReLU(i, o, k, dtype=dtype, device=device)

    n_out = ANCHORS_PER_SCALE * BOX_ATTRS
    if light:
        return (nn.Sequential(cbr(in_ch, emb_size, 1)),
                nn.Sequential(nn.Conv2d(emb_size, n_out, 1, device=device)))
    return (nn.Sequential(cbr(in_ch, emb_size, 1), cbr(emb_size, emb_size, 3),
                          cbr(emb_size, emb_size, 1)),
            nn.Sequential(cbr(emb_size, emb_size // 2, 1),
                          nn.Conv2d(emb_size // 2, n_out, 1, device=device)))


def fusion_fcn(fcn_emb: nn.Sequential, fcn_out: nn.Sequential,
               x: torch.Tensor, dtype: torch.dtype
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-scale fusion trunk + box head on an NHWC map. Returns
    (intermediate NHWC features, outbox (B, 3, 5, h, w))."""
    x = fcn_emb(x)
    intmd = x
    for m in fcn_out[:-1]:
        x = m(x)
    head = fcn_out[-1]
    x = conv_nhwc(x.to(dtype), head.weight, head.bias)
    b, h, w, _ = x.shape
    outbox = x.reshape(b, h, w, ANCHORS_PER_SCALE, BOX_ATTRS)
    return intmd, outbox.permute(0, 3, 4, 1, 2)  # (B, 3, 5, h, w)


def tile_language(flang: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C) -> (B, h, w, C) broadcast view."""
    return flang[:, None, None, :].expand(flang.shape[0], h, w, flang.shape[1])
