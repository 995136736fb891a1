"""K7: the eval-mode epilogue of a float convolution in one pass,
`act(bn(y)) [+ residual]`.

The BatchNorm on the running statistics, the activation (leaky ReLU with
the slope rounded to y's dtype, ReLU, or none) and the Darknet shortcut's
add read the conv output once and write the result once
(`csrc/bn_act.cu`, whose source note gives the bound and the design). No
TPU kernel: the JAX package leaves the epilogue to XLA's fusion. The
kernel rounds where the unfused passes round, so a card's bf16 output
equals `bn_act_plain` on the same card bit for bit; in fp32, where the
card's BatchNorm of a 4-D or 5-D map is cuDNN's, a few units of fp32 at
the magnitude of the affine's terms apart (`chip_smoke.K7_FP32_ULPS`).

`bn_act` dispatches: CPU tensors take `bn_act_plain` (the composition
the port ran before K7: `F.batch_norm` on the channels-last view, then the
activation, then the add); any other tensor launches the kernel or, where
the kernel cannot take it (`_check`: another device or dtype, a BatchNorm
without affine parameters, a residual of another dtype or shape, a call
that autograd records, since the kernel has no backward), raises
ValueError. A caller that needs gradients through an eval-mode BatchNorm
calls `bn_act_plain` itself. It is registered as
`torch.ops.dcnet.bn_act` (`torch.library.custom_op`, with a fake
implementation), which `torch.export` records; outside tracing the launch
is called directly, without the operator's dispatch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ACTS = {None: 0, "relu": 1, "leaky": 2}


@functools.lru_cache(maxsize=None)
def leaky_slope(dtype: torch.dtype) -> float:
    """0.1 rounded to `dtype`, as JAX applies a Python-float slope to a
    bf16 array (0.1 -> 0.10009765625)."""
    return torch.tensor(0.1, dtype=dtype).item()


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.1) with the slope rounded to x's dtype first, so bf16
    activations round as the JAX package's do."""
    return F.leaky_relu(x, leaky_slope(x.dtype))


def activate(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == "leaky":
        return leaky_relu(y)
    return F.relu(y) if act == "relu" else y


def bn_act_plain(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor, eps: float,
                 act: Optional[str] = None,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The unfused composition: inference BatchNorm over the last axis
    (fp32 math, stored in y's dtype, one pass), the activation, then
    `+ residual`."""
    out = F.batch_norm(y.movedim(-1, 1), mean, var, weight, bias, False, 0.0,
                       eps).movedim(1, -1)
    out = activate(out, act)
    return out if residual is None else out + residual


def _check(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
           weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
           residual: Optional[torch.Tensor]) -> None:
    """The kernel's input rules, ValueError where one fails: y on a CUDA
    device in fp32 or bf16, the four parameters fp32 on the same device,
    the residual (if any) y's dtype, shape and device, and nothing that
    autograd would record."""
    xs = [t for t in (y, mean, var, weight, bias, residual) if t is not None]
    if y.device.type != "cuda" or y.dtype not in _DTYPE_CODE or weight is None \
            or bias is None or any(p.dtype != torch.float32 or p.device != y.device
                                   for p in (mean, var, weight, bias)) \
            or (residual is not None and (residual.dtype != y.dtype
                                          or residual.shape != y.shape
                                          or residual.device != y.device)):
        raise ValueError(
            f"bn_act kernel takes y in float32 or bfloat16 on a CUDA device, fp32 "
            f"mean, var, weight and bias on its device and a residual of y's dtype and "
            f"shape, got {', '.join(f'{tuple(t.shape)} {t.dtype} on {t.device}' for t in xs)}"
            f"{'' if weight is not None and bias is not None else ' and no affine'}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in xs):
        raise ValueError("bn_act kernel has no backward: call bn_act_plain where "
                         "gradients flow through an eval-mode BatchNorm")


def bn_act(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
           weight: Optional[torch.Tensor], bias: Optional[torch.Tensor], eps: float,
           act: Optional[str] = None,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`act(bn(y)) [+ residual]` over the last axis of y (N, ..., C), bn on
    the running statistics: `bn_act_plain` on CPU tensors, else one K7
    launch (ValueError where `_check` refuses the inputs). `act` is None,
    "relu" or "leaky"."""
    if act not in ACTS:
        raise ValueError(f"bn_act: act is None, 'relu' or 'leaky', not {act!r}")
    if y.device.type == "cpu":
        return bn_act_plain(y, mean, var, weight, bias, eps, act, residual)
    _check(y, mean, var, weight, bias, residual)
    if torch.compiler.is_compiling():
        return bn_act_op(y, mean, var, weight, bias, eps, act, residual)
    return _launch(y, mean, var, weight, bias, eps, act, residual)


def _lib() -> ctypes.CDLL:
    lib = build.load("bn_act")
    if not getattr(lib, "_dcnet_bound", False):
        lib.dcnet_bn_act.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_float] * 2 + [ctypes.c_int]
            + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.dcnet_bn_act.restype = ctypes.c_int
        lib.dcnet_bn_act_error_string.argtypes = [ctypes.c_int]
        lib.dcnet_bn_act_error_string.restype = ctypes.c_char_p
        lib._dcnet_bound = True
    return lib


def _launch(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
            weight: torch.Tensor, bias: torch.Tensor, eps: float, act: Optional[str],
            residual: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of csrc/bn_act.cu on the current stream, counted as
    `bn_act`."""
    y = y.contiguous()
    residual = None if residual is None else residual.contiguous()
    params = [p.contiguous() for p in (mean, var, weight, bias)]
    c = y.shape[-1]
    out = torch.empty_like(y, memory_format=torch.contiguous_format)
    if y.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(y.device):
        err = lib.dcnet_bn_act(
            y.data_ptr(), None if residual is None else residual.data_ptr(),
            out.data_ptr(), *(p.data_ptr() for p in params), float(eps),
            leaky_slope(y.dtype), ACTS[act], y.numel() // c, c, _DTYPE_CODE[y.dtype],
            torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed (y {tuple(y.shape)} {y.dtype}, "
                           f"act {act}, residual {residual is not None}): "
                           f"{lib.dcnet_bn_act_error_string(err).decode()}")
    kernels.LAUNCHES["bn_act"] += 1
    return out


@torch.library.custom_op("dcnet::bn_act", mutates_args=())
def bn_act_op(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              weight: torch.Tensor, bias: torch.Tensor, eps: float, act: Optional[str],
              residual: Optional[torch.Tensor]) -> torch.Tensor:
    """K7 as an operator: CPU tensors take `bn_act_plain` (made
    contiguous), CUDA tensors launch the kernel (one count of `bn_act`)."""
    if y.device.type == "cpu":
        return bn_act_plain(y, mean, var, weight, bias, eps, act, residual).contiguous()
    _check(y, mean, var, weight, bias, residual)
    return _launch(y, mean, var, weight, bias, eps, act, residual)


@bn_act_op.register_fake
def _bn_act_fake(y, mean, var, weight, bias, eps, act, residual):
    xs = [t for t in (y, mean, var, weight, bias, residual) if t is not None]
    if any(t.device.type == "meta" for t in xs):
        raise ValueError(f"bn_act kernel needs its tensors on one CUDA device (or all "
                         f"on the CPU), got {', '.join(str(t.device) for t in xs)}")
    return torch.empty_like(y, memory_format=torch.contiguous_format)
