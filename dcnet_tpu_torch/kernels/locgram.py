"""K5: the fused location Gram, `ReLU((ce ceᵀ ∘ obj) W + b)`.

The port of `dcnet_tpu/ops/pallas/locgram.py::fused_loc_gram` (and its
`fold_dense_bn`). The CUDA kernel is `csrc/locgram.cu`, whose source note
gives the bound and the design: the exact rank-E factorisation
`ReLU(ce (ceᵀ (obj ∘ W)) + b)` in two launches (the (E, C) factor, then
the expansion), for any B <= 65535 and P, E, C >= 1. `loc_gram_plain`
keeps the TPU kernel's own algorithm (the Gram, then its product with W),
so it checks the kernel by another route. The JAX package never calls the
TPU kernel: `DCNet._trunk` computes the same function through the exact
rank-8 factorisation (`DenseBNReLU(None, gram_factors=...)`), and so does
the port, so no path of the port runs K5 either; `chip_smoke.py` launches
it in its kernel phase and holds it against that route on the model's own
inputs. CPU tensors take `loc_gram_plain`; CUDA tensors launch the kernel
or raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import nn

from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def loc_gram_plain(ce: torch.Tensor, obj: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """The plain version, with the TPU kernel's dtype rules: the Gram and
    the product in fp32 (fp64 for a float64 reference), the output in ce's
    dtype. ce (B, P, E), obj (B, P), w (P, C), b (C,) -> (B, P, C)."""
    acc = torch.promote_types(ce.dtype, torch.float32)
    cef = ce.to(acc)
    gram = torch.einsum("bpe,bqe->bpq", cef, cef) * obj.to(acc)[:, None, :]
    out = torch.einsum("bpq,qc->bpc", gram, w.to(acc)) + b.to(acc)
    return torch.relu(out).to(ce.dtype)


@torch.no_grad()
def fold_dense_bn(module: nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval-mode Linear + BatchNorm1d of a `DenseBNReLU` as one affine:
    (w (P, C), b (C,)) with w = Wᵀ s and b = (b_lin - mean) s + β, where
    s = γ / sqrt(var + eps), in fp32, outside autograd."""
    lin, bn = module[0], module[1]
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    w = lin.weight.float().t() * s[None, :]
    b = (lin.bias.float() - bn.running_mean.float()) * s + bn.bias.float()
    return w.contiguous(), b


def _lib() -> ctypes.CDLL:
    lib = build.load("locgram")
    if not getattr(lib, "_dcnet_bound", False):
        lib.dcnet_loc_gram.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                                       + [ctypes.c_void_p])
        lib.dcnet_loc_gram.restype = ctypes.c_int
        lib.dcnet_loc_gram_error_string.argtypes = [ctypes.c_int]
        lib.dcnet_loc_gram_error_string.restype = ctypes.c_char_p
        lib._dcnet_bound = True
    return lib


def _check(ce: torch.Tensor, obj: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor) -> None:
    """The kernel's input rules: one CUDA device; ce float32 or bfloat16,
    obj, w and b float32; ce (B, P, E), obj (B, P), w (P, C), b (C,), with
    B <= 65535 and B * E <= 64 * 65535 (grid dimensions) and P, E, C >= 1;
    all contiguous."""
    xs = {"ce": ce, "obj": obj, "w": w, "b": b}
    if any(x.device.type != "cuda" or x.device != ce.device for x in xs.values()):
        raise ValueError(f"loc-gram kernel needs ce, obj, w and b on one CUDA "
                         f"device, got {', '.join(str(x.device) for x in xs.values())}")
    if ce.dtype not in _DTYPE_CODE or any(
            x.dtype != torch.float32 for x in (obj, w, b)):
        raise TypeError(f"loc-gram kernel takes ce in float32 or bfloat16 and "
                        f"obj, w, b in float32, got "
                        f"{', '.join(str(x.dtype) for x in xs.values())}")
    if ce.dim() != 3 or obj.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"loc-gram kernel needs ce (B, P, E), obj (B, P), "
                         f"w (P, C) and b (C,), got "
                         f"{', '.join(str(tuple(x.shape)) for x in xs.values())}")
    bsz, p, e = ce.shape
    c = w.shape[1]
    if tuple(obj.shape) != (bsz, p) or w.shape[0] != p or tuple(b.shape) != (c,):
        raise ValueError(f"loc-gram kernel shapes disagree: ce {tuple(ce.shape)}, "
                         f"obj {tuple(obj.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    if bsz > 65535 or bsz * e > 64 * 65535 or min(bsz, p, e, c) < 1:
        raise ValueError(f"loc-gram kernel needs 1 <= B <= 65535, B * E <= "
                         f"64 * 65535 and P, E, C >= 1, got B={bsz}, P={p}, "
                         f"E={e}, C={c}")
    for name, x in xs.items():
        if not x.is_contiguous():
            raise ValueError(f"loc-gram kernel needs {name} contiguous, got "
                             f"strides {x.stride()}")


def fused_loc_gram(ce: torch.Tensor, obj: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """`ReLU((ce ceᵀ ∘ obj[:, None, :]) w + b)`: ce (B, P, E), obj (B, P),
    w (P, C) BN-folded, b (C,) -> (B, P, C) in ce's dtype. CPU tensors take
    `loc_gram_plain`; CUDA tensors launch the kernel (its two passes on the
    current stream, with an fp32 (B, E, C) workspace for the factor) or
    raise."""
    if all(x.device.type == "cpu" for x in (ce, obj, w, b)):
        return loc_gram_plain(ce, obj, w, b)
    _check(ce, obj, w, b)
    bsz, p, e = ce.shape
    c = w.shape[1]
    lib = _lib()
    out = torch.empty((bsz, p, c), dtype=ce.dtype, device=ce.device)
    factor = torch.empty((bsz, e, c), dtype=torch.float32, device=ce.device)
    with torch.cuda.device(ce.device):
        stream = torch.cuda.current_stream(ce.device).cuda_stream
        err = lib.dcnet_loc_gram(ce.data_ptr(), obj.data_ptr(), w.data_ptr(),
                                 b.data_ptr(), out.data_ptr(), factor.data_ptr(),
                                 bsz, p, e, c, _DTYPE_CODE[ce.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"loc-gram kernel launch failed (B={bsz}, P={p}, E={e}, C={c}, "
            f"{ce.dtype}): {lib.dcnet_loc_gram_error_string(err).decode()}")
    kernels.LAUNCHES["loc_gram"] += 1
    return out
