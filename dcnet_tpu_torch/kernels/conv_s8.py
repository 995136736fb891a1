"""K6: the int8 convolution, an NHWC implicit GEMM with a fused epilogue.

No TPU kernel stands behind it: the JAX package runs its int8 convolutions
through XLA (`lax.conv_general_dilated(int8, int8,
preferred_element_type=int32)`, `dcnet_tpu/ops/quant.py:224-227` and
`dcnet_tpu/models/heads.py:93-96`), and PyTorch has no int8 convolution on
CUDA. The CUDA kernel is `csrc/conv_s8.cuh` (mma.sync s8 x s8 -> s32, its
note gives the bound and the design), built as one library per input type
(`csrc/conv_s8.cu`, `conv_s8_bf16.cu`, `conv_s8_fp32.cu`), in parallel. `conv_s8_plain` is the plain version:
the int32 sums as a float64 product of the im2col matrix with the weights
(every partial sum an integer below 2^53, so exact in any order), then the
same epilogue with each fused multiply-add emulated exactly (`fma32`). CPU
tensors take it; CUDA tensors launch the kernel or raise.

x may be int8, or fp32 / bf16 quantized as the kernel gathers it, with the
JAX package's static-scale step: `clamp(round(x * in_inv), -127, 127)`
(the backbone) or `clamp(round(x / in_scale), -127, 127)` (the trunk,
`in_scale` an fp32 0-dim tensor on x's device, a true division).

The epilogue, each step optional, in this order: an int32 addend (the
shared half of the split corr_conv), `fma(float(acc), scale, bias)`, a
second `fma(y, scale2, bias2)` (the trunk's BatchNorm), ReLU or
LeakyReLU(0.1), then the output as fp32, bf16 or, requantised with
`inv_out` for the next convolution, int8. Without a scale the raw int32
sums come out. The multiply-adds are fused on purpose: XLA's CPU backend
contracts the JAX package's `y.astype(f32) * scale + bias` into one FMA
(2^20 random accumulators, scales and biases: all equal to an exactly
rounded FMA, 75% equal to a multiply then an add), so two roundings would
move int8 codes away from the JAX package's.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.kernels import build

_MODE = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2, torch.int8: 3}
_X_DTYPE = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
SOURCES = {torch.int8: "conv_s8", torch.bfloat16: "conv_s8_bf16",
           torch.float32: "conv_s8_fp32"}   # x's dtype -> csrc/<name>.cu
_ACT = {None: 0, "relu": 1, "leaky": 2}


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """`a * b + c` rounded once to fp32, as a fused multiply-add: the
    product of two fp32 values is exact in float64; the sum is taken in
    float64 and rounded to odd (its error from TwoSum decides the last
    bit), after which one rounding to fp32 is the correctly rounded FMA
    (53 >= 24 + 2 bits). a, b, c fp32, broadcastable."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where(even & (err != 0), torch.nextafter(s, toward), s)
    return s.float()


def conv_s8_acc_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                      pad: int = 0) -> torch.Tensor:
    """The int32 sums of x (N, H, W, Ci) int8 with w (Co, k, k, Ci) int8:
    (N, Ho, Wo, Co) int32, as a float64 product of the im2col matrix and
    the weights (|sum| <= 127^2 k^2 Ci < 2^53: exact)."""
    n, h, wd, ci = x.shape
    co, k = w.shape[0], w.shape[1]
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    cols = F.unfold(x.permute(0, 3, 1, 2).double(), k, padding=pad,
                    stride=stride)                        # (N, Ci k k, L)
    wf = w.permute(0, 3, 1, 2).reshape(co, -1).double()   # (Co, Ci k k)
    acc = torch.matmul(wf, cols)                          # (N, Co, L)
    return acc.transpose(1, 2).reshape(n, ho, wo, co).to(torch.int32)


def _addend_rows(m: int, addend: torch.Tensor, hw: int, rep: int) -> torch.Tensor:
    """The addend's row for each output row: (row // (rep hw)) hw + row % hw."""
    rows = torch.arange(m, device=addend.device)
    return (rows // (rep * hw)) * hw + rows % hw


def epilogue_plain(acc: torch.Tensor, scale=None, bias=None, scale2=None,
                   bias2=None, act: Optional[str] = None,
                   out_dtype: torch.dtype = torch.int32,
                   inv_out: Optional[float] = None,
                   addend: Optional[torch.Tensor] = None,
                   addend_hw: int = 1, addend_rep: int = 1) -> torch.Tensor:
    """The kernel's epilogue on int32 sums acc (..., Co), step by step as
    `csrc/conv_s8.cuh::finish` takes them."""
    if addend is not None:
        co = acc.shape[-1]
        flat = acc.reshape(-1, co)
        rows = _addend_rows(flat.shape[0], addend, addend_hw, addend_rep)
        acc = (flat + addend.reshape(-1, co)[rows]).reshape(acc.shape)
    if scale is None:
        return acc
    y = fma32(acc.float(), scale, bias)
    if scale2 is not None:
        y = fma32(y, scale2, bias2)
    if act == "relu":
        y = torch.where(y > 0, y, torch.zeros_like(y))
    elif act == "leaky":
        y = torch.where(y >= 0, y, y * 0.1)
    if out_dtype == torch.int8:
        return torch.clamp(torch.round(y * inv_out), -127, 127).to(torch.int8)
    return y.to(out_dtype)


def quantize_plain(x: torch.Tensor, in_inv: Optional[float] = None,
                   in_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's input quantization: an int8 x as it is; a float x as
    clamp(round(x * in_inv)) or clamp(round(x / in_scale)), in fp32, round
    half to even, as int8."""
    if x.dtype == torch.int8:
        return x
    y = x.float() * in_inv if in_scale is None else x.float() / in_scale
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def conv_s8_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                  pad: int = 0, in_inv: Optional[float] = None,
                  in_scale: Optional[torch.Tensor] = None, **epilogue) -> torch.Tensor:
    """The plain version of `conv_s8`: `quantize_plain`,
    `conv_s8_acc_plain`, then `epilogue_plain`."""
    xq = quantize_plain(x, in_inv, in_scale)
    return epilogue_plain(conv_s8_acc_plain(xq, w, stride, pad), **epilogue)


def conv_vec(ci: int, x: torch.Tensor, w: torch.Tensor) -> int:
    """The kernel's gather width for Ci input channels, in elements: 16 when
    Ci % 16 == 0, 4 when Ci % 4 == 0 (x's data aligned to that many of its
    elements, w's to that many bytes), else 1."""
    for vec in (16, 4):
        if (ci % vec == 0 and x.data_ptr() % (vec * x.element_size()) == 0
                and w.data_ptr() % vec == 0):
            return vec
    return 1


def _lib(x_dtype: torch.dtype = torch.int8) -> ctypes.CDLL:
    """The library of K6 for inputs of `x_dtype`, built first if needed."""
    lib = build.load(SOURCES[x_dtype])
    if not getattr(lib, "_dcnet_bound", False):
        lib.dcnet_conv_s8.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float]
            + [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 + [ctypes.c_float]
            + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.dcnet_conv_s8.restype = ctypes.c_int
        lib.dcnet_conv_s8_error_string.argtypes = [ctypes.c_int]
        lib.dcnet_conv_s8_error_string.restype = ctypes.c_char_p
        lib._dcnet_bound = True
    return lib


def _check(x, w, stride, pad, floats, addend, out_dtype, inv_out, in_inv,
           in_scale) -> None:
    """The kernel's input rules: one CUDA device; x (N, H, W, Ci) int8 (or
    fp32 / bf16 with exactly one of in_inv and in_scale, an fp32 0-dim
    tensor) and w (Co, k, k, Ci) int8, both contiguous; scale/bias/
    scale2/bias2 (Co,) fp32 contiguous; an addend int32 (rows, Co)
    contiguous; stride >= 1, pad >= 0, the kernel within the padded image;
    int8 output needs inv_out."""
    tensors = [x, w, *[f for f in floats if f is not None]]
    tensors += [t for t in (addend, in_scale) if t is not None]
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError(f"int8 conv kernel needs every tensor on one CUDA device, "
                         f"got {', '.join(str(t.device) for t in tensors)}")
    if x.dtype not in _X_DTYPE or w.dtype != torch.int8:
        raise TypeError(f"int8 conv kernel takes an int8, fp32 or bf16 x and an int8 "
                        f"w, got {x.dtype}, {w.dtype}")
    if (x.dtype == torch.int8) != (in_inv is None and in_scale is None) or (
            in_inv is not None and in_scale is not None):
        raise ValueError("int8 conv kernel: a float x takes exactly one of in_inv and "
                         "in_scale, an int8 x neither")
    if in_scale is not None and (in_scale.dtype != torch.float32 or in_scale.numel() != 1):
        raise ValueError(f"int8 conv kernel needs in_scale an fp32 scalar tensor, got "
                         f"{in_scale.dtype} {tuple(in_scale.shape)}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[1] != w.shape[2] or w.shape[3] != x.shape[3]:
        raise ValueError(f"int8 conv kernel needs x (N, H, W, Ci) and w (Co, k, k, "
                         f"Ci), got {tuple(x.shape)} and {tuple(w.shape)}")
    co, k = w.shape[0], w.shape[1]
    if stride < 1 or pad < 0 or x.shape[1] + 2 * pad < k or x.shape[2] + 2 * pad < k:
        raise ValueError(f"int8 conv kernel: bad stride {stride} / pad {pad} for "
                         f"x {tuple(x.shape)} and a {k}x{k} kernel")
    for t in floats:
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (co,)
                              or not t.is_contiguous()):
            raise ValueError(f"int8 conv kernel needs scales and biases fp32 ({co},) "
                             f"contiguous, got {t.dtype} {tuple(t.shape)}")
    if addend is not None and (addend.dtype != torch.int32 or addend.shape[-1] != co
                               or not addend.is_contiguous()):
        raise ValueError(f"int8 conv kernel needs an int32 (rows, {co}) addend, got "
                         f"{addend.dtype} {tuple(addend.shape)}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("int8 conv kernel needs x and w contiguous")
    if out_dtype not in _MODE:
        raise TypeError(f"int8 conv kernel writes int32, float32, bfloat16 or int8, "
                        f"not {out_dtype}")
    if out_dtype == torch.int8 and inv_out is None:
        raise ValueError("an int8 output needs inv_out, the next input's 1/scale")


def conv_s8(x: torch.Tensor, w: torch.Tensor, stride: int = 1, pad: int = 0,
            scale: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
            scale2: Optional[torch.Tensor] = None, bias2: Optional[torch.Tensor] = None,
            act: Optional[str] = None, out_dtype: torch.dtype = torch.int32,
            inv_out: Optional[float] = None, addend: Optional[torch.Tensor] = None,
            addend_hw: int = 1, addend_rep: int = 1, in_inv: Optional[float] = None,
            in_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The convolution of x (N, H, W, Ci) (int8, or fp32 / bf16 quantized
    with `in_inv` or `in_scale`) with w (Co, k, k, Ci) int8, zero padding
    `pad`, and its epilogue (module doc): (N, Ho, Wo, Co) in `out_dtype`
    (int32 raw sums when `scale` is None). `act` is None, "relu" or
    "leaky". CPU tensors take `conv_s8_plain`; CUDA tensors launch the
    kernel on the current stream or raise."""
    if (scale is None) != (out_dtype == torch.int32) or (scale is None) != (bias is None) \
            or (scale2 is None) != (bias2 is None) or act not in _ACT:
        raise ValueError("conv_s8: int32 output takes no scale; a scale needs a bias, "
                         "scale2 needs bias2, act is None, 'relu' or 'leaky'")
    epilogue = dict(scale=scale, bias=bias, scale2=scale2, bias2=bias2, act=act,
                    out_dtype=out_dtype, inv_out=inv_out, addend=addend,
                    addend_hw=addend_hw, addend_rep=addend_rep)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv_s8_plain(x, w, stride, pad, in_inv=in_inv, in_scale=in_scale,
                             **epilogue)
    floats = (scale, bias, scale2, bias2)
    _check(x, w, stride, pad, floats, addend, out_dtype, inv_out, in_inv, in_scale)
    n, h, wd, ci = x.shape
    co, k = w.shape[0], w.shape[1]
    ho, wo = (h + 2 * pad - k) // stride + 1, (wd + 2 * pad - k) // stride + 1
    out = torch.empty((n, ho, wo, co), dtype=out_dtype, device=x.device)
    vec = conv_vec(ci, x, w)
    lib = _lib(x.dtype)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        qmode = 0 if x.dtype == torch.int8 else (1 if in_scale is None else 2)
        err = lib.dcnet_conv_s8(
            x.data_ptr(), _X_DTYPE[x.dtype], qmode,
            float(in_inv) if in_inv is not None else 0.0, ptr(in_scale),
            w.data_ptr(), out.data_ptr(), *[ptr(t) for t in floats],
            ptr(addend), addend_hw, addend_rep,
            float(inv_out) if inv_out is not None else 0.0,
            n, h, wd, ci, co, k, stride, pad, _MODE[out_dtype], _ACT[act], vec, stream)
    if err != 0:
        raise RuntimeError(
            f"int8 conv kernel launch failed (x {tuple(x.shape)} {x.dtype}, "
            f"w {tuple(w.shape)}, "
            f"stride {stride}, pad {pad}, {out_dtype}, vec {vec}): "
            f"{lib.dcnet_conv_s8_error_string(err).decode()}")
    kernels.LAUNCHES["conv_s8"] += 1
    return out
