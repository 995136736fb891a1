"""K1: single-direction co-attention, `softmax_rows(T * q kvᵀ) kv`.

The port of `dcnet_tpu/ops/pallas/coattn.py::_attend` and its entry points
`coattention_one` / `coattention_center_fused`. The kernel is CUDA C++ in
`csrc/coattn.cu` (its source note gives the bound and the design); this
module binds it with `ctypes`, holds its plain PyTorch version, and
dispatches on where the tensors lie: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attend_plain(q: torch.Tensor, kv: torch.Tensor,
                 temperature: float) -> torch.Tensor:
    """The plain version, with the TPU kernel's dtype rules: fp32 logits and
    softmax, weights rounded to bf16 before the PV product when kv is bf16,
    fp32 accumulation, output in q's dtype. q, kv: (B, P, C)."""
    kvf = kv.float()
    logits = torch.matmul(q.float(), kvf.transpose(1, 2)) * temperature
    w = torch.softmax(logits, dim=-1)
    if kv.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).float()
    return torch.matmul(w, kvf).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("coattn")
    if not getattr(lib, "_dcnet_bound", False):
        lib.dcnet_coattn_attend.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.dcnet_coattn_attend.restype = ctypes.c_int
        lib.dcnet_coattn_error_string.argtypes = [ctypes.c_int]
        lib.dcnet_coattn_error_string.restype = ctypes.c_char_p
        lib._dcnet_bound = True
    return lib


def _check(q: torch.Tensor, kv: torch.Tensor) -> None:
    if q.device.type != "cuda" or kv.device != q.device:
        raise ValueError(f"coattention kernel needs q and kv on one CUDA "
                         f"device, got {q.device} and {kv.device}")
    if q.dtype not in _DTYPE_CODE or kv.dtype != q.dtype:
        raise TypeError(f"coattention kernel takes float32 or bfloat16 "
                        f"(both the same), got {q.dtype} and {kv.dtype}")
    if q.dim() != 3 or q.shape != kv.shape:
        raise ValueError(f"coattention kernel needs q, kv of one (B, P, C) "
                         f"shape, got {tuple(q.shape)} and {tuple(kv.shape)}")
    b, p, c = q.shape
    if c % 16 or b > 65535:
        raise ValueError(f"coattention kernel needs C % 16 == 0 and "
                         f"B <= 65535, got B={b}, C={c}")
    for name, x in (("q", q), ("kv", kv)):
        # rows contiguous; any batch stride (a frame sliced out of a clip)
        if x.stride(2) != 1 or (p > 1 and x.stride(1) != c):
            raise ValueError(f"coattention kernel needs {name} rows "
                             f"contiguous, got strides {x.stride()}")
        if x.data_ptr() % 16 or (x.stride(0) * x.element_size()) % 16:
            raise ValueError(f"coattention kernel needs {name} 16-byte "
                             f"aligned per batch row")


def coattention_one(q: torch.Tensor, kv: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """Attended-for-q: softmax_rows(T q kvᵀ) kv. q, kv: (B, P, C) -> (B, P, C)
    in q's dtype. CPU tensors take the plain version; CUDA tensors launch
    the kernel (on the current stream) or raise."""
    if q.device.type == "cpu" and kv.device.type == "cpu":
        return attend_plain(q, kv, temperature)
    _check(q, kv)
    lib = _lib()
    b, p, c = q.shape
    out = torch.empty((b, p, c), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dcnet_coattn_attend(
            q.data_ptr(), kv.data_ptr(), out.data_ptr(), b, p, c,
            q.stride(0), kv.stride(0), float(temperature), _DTYPE_CODE[q.dtype],
            stream)
    if err != 0:
        raise RuntimeError(
            f"coattention kernel launch failed (B={b}, P={p}, C={c}, "
            f"{q.dtype}): {lib.dcnet_coattn_error_string(err).decode()}")
    kernels.LAUNCHES["coattn_attend"] += 1
    return out


def coattention_center_fused(center: torch.Tensor, ref: torch.Tensor,
                             temperature: float = 10.0) -> torch.Tensor:
    """Drop-in for ops.coattention.coattention_center on NHWC (B, H, W, C)
    maps: the center frame attended to one reference, through K1."""
    b, h, w, c = center.shape
    out = coattention_one(center.reshape(b, h * w, c),
                          ref.reshape(b, h * w, c), temperature)
    return out.reshape(b, h, w, c)
