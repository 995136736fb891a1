"""Co-attention kernels K1, K2, K3 and K4, with the gradients of K1 and K2.

K1, `softmax_rows(T * q kvᵀ) kv`, is the port of
`dcnet_tpu/ops/pallas/coattn.py::_attend`; K2, the pair `(K1(f1, f2),
K1(f2, f1))` of the training step, of `coattention_fused`; K3, the
backward of one direction, of `_attend_bwd`; K4, the center frame against
every reference straight off a (B, S, P, C) feature ring (float or int8),
of `coattention_ring`. K1 and K2 are one CUDA kernel in `csrc/coattn.cu`
(K2's grid spans the direction), K3 is `csrc/coattn_bwd.cu`, K4
`csrc/coattn_ring.cu`. K1, K2 and K4 share their blocks, chosen by dtype
and width (`csrc/blocks.cuh`, `attend_body`): `csrc/attend_wgmma.cuh` for
bf16, `csrc/attend_tf32.cuh` for fp32, `csrc/attend_s8.cuh` for int8 rings,
`csrc/attend_tile.cuh` for other bf16 widths and `csrc/attend_wide.cuh`
for every other width; K3 and the fp32 block share the 3xTF32 tensor-core
primitives of `csrc/tf32x3.cuh`, and K3 has a general pass of its own for
other widths (`attend_bwd_body`). Every width C >= 1 the JAX package runs
has a kernel. Their source notes give the bounds and the designs. This
module binds them with `ctypes`, holds their plain PyTorch versions, and
dispatches on where the tensors lie: CPU tensors take the plain versions,
CUDA tensors launch the kernels or raise.

The gradients are `torch.autograd.Function`s, as the JAX package's are
`custom_vjp`s: `coattention_one` is K1 forward and K3 backward, and
`coattention_fused` is K2 forward and two K3 backward, combined as
df1 = dq1 + dkv2 and df2 = dkv1 + dq2, the sum taken in the input dtype.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_RING_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
INT8_SCALE = 127.0
# the WMMA block's shared memory (csrc/attend_tile.cuh) holds bf16 widths up
# to 672 within a block's 232,448 bytes; 688 would need 235,776
TILE_MAX_C = 672


def attend_body(dtype: torch.dtype, c: int) -> str:
    """Which block K1, K2 and K4 launch for inputs of `dtype` (int8: K4's
    rings) with C channels, for records and tests: "wgmma"
    (csrc/attend_wgmma.cuh: bf16, C % 128 == 0, C <= 512, every bf16
    configuration the repository runs), "tf32x3" (csrc/attend_tf32.cuh:
    fp32, C % 16 == 0, C <= 512), "wgmma_s8" (csrc/attend_s8.cuh: int8
    rings, C % 128 == 0, C <= 512), "block" (csrc/attend_tile.cuh: WMMA for
    other bf16 widths with C % 16 == 0, C <= 672) or "wide" (the general
    block of csrc/attend_wide.cuh, every other width). The C entry points
    make the choice (`csrc/blocks.cuh`, `dcnet_coattn_block`, which the
    card-only tests hold this against), by shape, never as a fallback."""
    whole = c % 128 == 0 and 128 <= c <= 512
    if dtype == torch.bfloat16:
        return "wgmma" if whole else (
            "block" if c % 16 == 0 and 16 <= c <= TILE_MAX_C else "wide")
    if dtype == torch.float32:
        return "tf32x3" if c % 16 == 0 and 16 <= c <= 512 else "wide"
    return "wgmma_s8" if whole else "wide"


def attend_bwd_body(c: int) -> str:
    """Which pass K3 launches at width C: "tf32x3" (the 3xTF32 passes of
    csrc/coattn_bwd.cu, C % 16 == 0, C <= 512) or "wide" (its general pass,
    every other width)."""
    return "tf32x3" if c % 16 == 0 and 16 <= c <= 512 else "wide"


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' math type: fp32, or fp64 for a float64 reference."""
    return torch.promote_types(dtype, torch.float32)


def attend_plain(q: torch.Tensor, kv: torch.Tensor,
                 temperature: float) -> torch.Tensor:
    """The plain version, with the TPU kernel's dtype rules: fp32 logits and
    softmax, weights rounded to bf16 before the PV product when kv is bf16,
    fp32 accumulation, output in q's dtype. q, kv: (B, P, C)."""
    kvf = kv.to(_acc(kv.dtype))
    logits = torch.matmul(q.to(kvf.dtype), kvf.transpose(1, 2)) * temperature
    w = torch.softmax(logits, dim=-1)
    if kv.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).to(kvf.dtype)
    return torch.matmul(w, kvf).to(q.dtype)


def attend_bwd_plain(q: torch.Tensor, kv: torch.Tensor, temperature: float,
                     g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K3, the body of the TPU kernel on full rows:
    everything in fp32 with the unrounded softmax W (not the autograd of
    `attend_plain`, whose W is rounded to bf16 for bf16 inputs),
        dW = g kvᵀ, dS = W (dW - rowsum(dW W)),
        dq = T dS kv, dkv = T dSᵀ q + Wᵀ g,
    each cast to its input's dtype. q, kv, g: (B, P, C)."""
    acc = _acc(q.dtype)
    qf, kvf, gf = q.to(acc), kv.to(acc), g.to(acc)
    w = torch.softmax(torch.matmul(qf, kvf.transpose(1, 2)) * temperature, dim=-1)
    dw = torch.matmul(gf, kvf.transpose(1, 2))
    ds = w * (dw - torch.sum(dw * w, dim=-1, keepdim=True))
    dq = temperature * torch.matmul(ds, kvf)
    dkv = (temperature * torch.matmul(ds.transpose(1, 2), qf)
           + torch.matmul(w.transpose(1, 2), gf))
    return dq.to(q.dtype), dkv.to(kv.dtype)


def _newest_slot(s: int, center_t: int, newest_slot=None) -> int:
    """The physical slot of a ring's newest frame (None: S - 1, physical
    order is temporal order), checked with the center's temporal index."""
    slot = s - 1 if newest_slot is None else int(newest_slot)
    if not 0 <= slot < s or not 0 <= center_t < s:
        raise ValueError(f"ring of {s} frames: newest_slot {newest_slot} and "
                         f"center_t {center_t} must lie in [0, {s})")
    return slot


def ring_slots(s: int, center_t: int, newest_slot=None) -> Tuple[int, list]:
    """Physical slots of the center and of the references (temporal order,
    the center skipped) in a ring of S frames whose newest frame sits in
    slot `newest_slot`: temporal frame j lives in slot
    (newest_slot + 1 + j) mod S."""
    slot = _newest_slot(s, center_t, newest_slot)
    return ((slot + 1 + center_t) % s,
            [(slot + 1 + j) % s for j in range(s) if j != center_t])


def _ring_out_dtype(ring_dtype: torch.dtype) -> torch.dtype:
    """K4's output dtype: bf16 for int8 rings, the ring's dtype otherwise."""
    return torch.bfloat16 if ring_dtype == torch.int8 else ring_dtype


def ring_attend_plain(ring: torch.Tensor, temperature: float, center_t: int,
                      newest_slot=None) -> torch.Tensor:
    """The plain version of K4, the TPU kernel's body on full rows. ring:
    (B, S, P, C) -> (B, S-1, P, C), the center frame attended to each
    reference in temporal order. Float rings follow `attend_plain`'s dtype
    rules. int8 rings: logits are the int8 products summed exactly and
    rounded once to fp32, times T/127²; kv is dequantised as
    bf16(bf16(kv) * bf16(1/127)); the weights are rounded to bf16 and the PV
    product sums in fp32. Output in the ring's dtype (bf16 for int8)."""
    b, s, p, c = ring.shape
    cs, rs = ring_slots(s, center_t, newest_slot)
    cen = ring[:, cs:cs + 1]                          # (B, 1, P, C)
    refs = torch.stack([ring[:, r] for r in rs], dim=1)  # (B, R, P, C), no index tensor
    if ring.dtype == torch.int8:
        # the integer products summed exactly (float64 holds 127² C), then
        # rounded to fp32 once, as XLA's astype rounds the int32 sums
        logits = (torch.matmul(cen.double(), refs.double().transpose(2, 3)).float()
                  * (temperature / (INT8_SCALE * INT8_SCALE)))
        scale = torch.tensor(1.0 / INT8_SCALE, dtype=torch.bfloat16)
        kvf = (refs.to(torch.bfloat16) * scale).float()
        w = torch.softmax(logits, dim=-1).to(torch.bfloat16).float()
    else:
        kvf = refs.to(_acc(ring.dtype))
        logits = torch.matmul(cen.to(kvf.dtype), kvf.transpose(2, 3)) * temperature
        w = torch.softmax(logits, dim=-1)
        if ring.dtype == torch.bfloat16:
            w = w.to(torch.bfloat16).to(kvf.dtype)
    return torch.matmul(w, kvf).to(_ring_out_dtype(ring.dtype))


def _lib() -> ctypes.CDLL:
    lib = build.load("coattn")
    if not getattr(lib, "_dcnet_bound", False):
        lib.dcnet_coattn_attend.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.dcnet_coattn_attend.restype = ctypes.c_int
        lib.dcnet_coattn_block.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dcnet_coattn_block.restype = ctypes.c_int
        lib.dcnet_coattn_error_string.argtypes = [ctypes.c_int]
        lib.dcnet_coattn_error_string.restype = ctypes.c_char_p
        lib._dcnet_bound = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("coattn_bwd")
    if not getattr(lib, "_dcnet_bound", False):
        lib.dcnet_coattn_attend_bwd.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
            + [ctypes.c_longlong] * 3
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.dcnet_coattn_attend_bwd.restype = ctypes.c_int
        lib.dcnet_coattn_bwd_block.argtypes = [ctypes.c_int]
        lib.dcnet_coattn_bwd_block.restype = ctypes.c_int
        lib.dcnet_coattn_bwd_error_string.argtypes = [ctypes.c_int]
        lib.dcnet_coattn_bwd_error_string.restype = ctypes.c_char_p
        lib._dcnet_bound = True
    return lib


def _ring_lib() -> ctypes.CDLL:
    lib = build.load("coattn_ring")
    if not getattr(lib, "_dcnet_bound", False):
        lib.dcnet_coattn_ring.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 2
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.dcnet_coattn_ring.restype = ctypes.c_int
        lib.dcnet_coattn_ring_error_string.argtypes = [ctypes.c_int]
        lib.dcnet_coattn_ring_error_string.restype = ctypes.c_char_p
        lib._dcnet_bound = True
    return lib


def _check(body: str, **xs: torch.Tensor) -> None:
    """The kernels' input rules: one CUDA device, float32 or bfloat16 (all
    the same), one (B, P, C) shape, C >= 1, B <= 65535, rows contiguous
    (row stride C), any batch stride (a frame sliced out of a clip); rows
    16-byte aligned for every block but the general one (`body` "wide"),
    whose loads are one element wide."""
    (n0, x0), *_ = xs.items()
    if any(x.device.type != "cuda" or x.device != x0.device for x in xs.values()):
        raise ValueError(f"coattention kernel needs {', '.join(xs)} on one "
                         f"CUDA device, got "
                         f"{', '.join(str(x.device) for x in xs.values())}")
    if x0.dtype not in _DTYPE_CODE or any(x.dtype != x0.dtype for x in xs.values()):
        raise TypeError(f"coattention kernel takes float32 or bfloat16 (all "
                        f"the same), got "
                        f"{', '.join(str(x.dtype) for x in xs.values())}")
    if x0.dim() != 3 or any(x.shape != x0.shape for x in xs.values()):
        raise ValueError(f"coattention kernel needs {', '.join(xs)} of one "
                         f"(B, P, C) shape, got "
                         f"{', '.join(str(tuple(x.shape)) for x in xs.values())}")
    b, p, c = x0.shape
    if c < 1 or b > 65535:
        raise ValueError(f"coattention kernel needs C >= 1 and B <= 65535, "
                         f"got B={b}, C={c}")
    for name, x in xs.items():
        if not _rows_ok(x, aligned=body != "wide"):
            raise ValueError(f"coattention kernel needs {name} rows "
                             f"contiguous (and, on the {body} block, 16-byte "
                             f"aligned per batch row), got strides {x.stride()}")


def _rows_ok(x: torch.Tensor, aligned: bool = True) -> bool:
    """The kernels' layout rule for a (B, P, C) tensor: rows contiguous,
    any batch stride; with `aligned`, 16-byte aligned per batch row."""
    p, c = x.shape[1], x.shape[2]
    contiguous = x.stride(2) == 1 and (p == 1 or x.stride(1) == c)
    return contiguous and (not aligned or (
        x.data_ptr() % 16 == 0 and (x.stride(0) * x.element_size()) % 16 == 0))


def _on_cpu(*xs: torch.Tensor) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def _launch_attend(q: torch.Tensor, kv: torch.Tensor, temperature: float,
                   pair: bool):
    """One launch of csrc/coattn.cu: K1 (out = attend(q, kv)) or, with
    `pair`, K2 (also out2 = attend(kv, q)). Counts nothing."""
    _check(attend_body(q.dtype, q.shape[-1]), q=q, kv=kv)
    lib = _lib()
    b, p, c = q.shape
    out = torch.empty((b, p, c), dtype=q.dtype, device=q.device)
    out2 = torch.empty_like(out) if pair else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dcnet_coattn_attend(
            q.data_ptr(), kv.data_ptr(), out.data_ptr(),
            out2.data_ptr() if pair else None, b, p, c, q.stride(0),
            kv.stride(0), float(temperature), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"coattention {'pair ' if pair else ''}kernel launch failed "
            f"(B={b}, P={p}, C={c}, {q.dtype}): "
            f"{lib.dcnet_coattn_error_string(err).decode()}")
    return (out, out2) if pair else out


def _rows_contiguous(x: torch.Tensor) -> torch.Tensor:
    """x itself where its rows are contiguous and aligned as the kernels
    need, else a contiguous copy (a gradient sliced out of a concat)."""
    return x if _rows_ok(x) else x.contiguous()


def attend_bwd(q: torch.Tensor, kv: torch.Tensor, temperature: float,
               g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dq, dkv) of attend(q, kv) for the upstream gradient g, each in
    its input's dtype. CPU tensors take `attend_bwd_plain`; CUDA tensors
    launch the kernel (two grids, one count) or raise."""
    if _on_cpu(q, kv, g):
        return attend_bwd_plain(q, kv, temperature, g)
    _check(attend_bwd_body(q.shape[-1]), q=q, kv=kv, g=g)
    b, p, c = q.shape
    lib = _bwd_lib()
    dq = torch.empty((b, p, c), dtype=q.dtype, device=q.device)
    dkv = torch.empty_like(dq)
    lse = torch.empty((b, p), dtype=torch.float32, device=q.device)
    dd = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dcnet_coattn_attend_bwd(
            q.data_ptr(), kv.data_ptr(), g.data_ptr(), dq.data_ptr(),
            dkv.data_ptr(), lse.data_ptr(), dd.data_ptr(), b, p, c,
            q.stride(0), kv.stride(0), g.stride(0), float(temperature),
            _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"coattention backward kernel launch failed (B={b}, P={p}, C={c}, "
            f"{q.dtype}): {lib.dcnet_coattn_bwd_error_string(err).decode()}")
    kernels.LAUNCHES["coattn_attend_bwd"] += 1
    return dq, dkv


class _AttendOne(torch.autograd.Function):
    """K1 forward, K3 backward (the JAX package's `_one_fwd` / `_one_bwd`)."""

    @staticmethod
    def forward(ctx, q, kv, temperature):
        ctx.save_for_backward(q, kv)
        ctx.temperature = temperature
        if _on_cpu(q, kv):
            return attend_plain(q, kv, temperature)
        out = _launch_attend(q, kv, temperature, pair=False)
        kernels.LAUNCHES["coattn_attend"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        q, kv = ctx.saved_tensors
        dq, dkv = attend_bwd(q, kv, ctx.temperature, _rows_contiguous(g))
        return dq, dkv, None


class _AttendPair(torch.autograd.Function):
    """K2 forward, two K3 backward (the JAX package's `_fwd` / `_bwd`)."""

    @staticmethod
    def forward(ctx, f1, f2, temperature):
        ctx.save_for_backward(f1, f2)
        ctx.temperature = temperature
        if _on_cpu(f1, f2):
            return attend_plain(f1, f2, temperature), attend_plain(f2, f1, temperature)
        o1, o2 = _launch_attend(f1, f2, temperature, pair=True)
        kernels.LAUNCHES["coattn_pair"] += 1
        return o1, o2

    @staticmethod
    def backward(ctx, g1, g2):
        f1, f2 = ctx.saved_tensors
        t = ctx.temperature
        dq1, dkv1 = attend_bwd(f1, f2, t, _rows_contiguous(g1))
        dq2, dkv2 = attend_bwd(f2, f1, t, _rows_contiguous(g2))
        return dq1 + dkv2, dkv1 + dq2, None


def coattention_one(q: torch.Tensor, kv: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """Attended-for-q: softmax_rows(T q kvᵀ) kv. q, kv: (B, P, C) -> (B, P, C)
    in q's dtype, differentiable (K3). CPU tensors take the plain versions;
    CUDA tensors launch the kernels (on the current stream) or raise."""
    return _AttendOne.apply(q, kv, temperature)


def coattention_fused(f1: torch.Tensor, f2: torch.Tensor, temperature: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (attended_for_f1, attended_for_f2) = (attend(f1, f2),
    attend(f2, f1)), the contract of ops.coattention.coattention_pair on
    flattened patches. f1, f2: (B, P, C); differentiable (2 x K3)."""
    return _AttendPair.apply(f1, f2, temperature)


def coattention_center_fused(center: torch.Tensor, ref: torch.Tensor,
                             temperature: float = 10.0) -> torch.Tensor:
    """Drop-in for ops.coattention.coattention_center on NHWC (B, H, W, C)
    maps: the center frame attended to one reference, through K1."""
    b, h, w, c = center.shape
    out = coattention_one(center.reshape(b, h * w, c),
                          ref.reshape(b, h * w, c), temperature)
    return out.reshape(b, h, w, c)


def coattention_pair_fused(f1: torch.Tensor, f2: torch.Tensor,
                           temperature: float = 10.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ops.coattention.coattention_pair on NHWC (B, H, W, C)
    maps: both directions through K2."""
    b, h, w, c = f1.shape
    o1, o2 = coattention_fused(f1.reshape(b, h * w, c),
                               f2.reshape(b, h * w, c), temperature)
    return o1.reshape(b, h, w, c), o2.reshape(b, h, w, c)


def _check_ring(ring: torch.Tensor) -> None:
    """K4's input rules: a CUDA (B, S, P, C) ring in float32, bfloat16 or
    int8 with S >= 2, C >= 1, rows of C contiguous; frames 16-byte aligned
    (any batch and slot stride) for every block but the general one."""
    if ring.device.type != "cuda":
        raise ValueError(f"ring kernel needs the ring on a CUDA device, got "
                         f"{ring.device}")
    if ring.dtype not in _RING_DTYPE_CODE:
        raise TypeError(f"ring kernel takes float32, bfloat16 or int8 rings, "
                        f"got {ring.dtype}")
    if ring.dim() != 4 or ring.shape[1] < 2 or ring.shape[3] < 1:
        raise ValueError(f"ring kernel needs a (B, S, P, C) ring with S >= 2 "
                         f"and C >= 1, got {tuple(ring.shape)}")
    b, s, p, c = ring.shape
    size = ring.element_size()
    aligned = (ring.data_ptr() % 16 == 0 and (ring.stride(0) * size) % 16 == 0
               and (ring.stride(1) * size) % 16 == 0)
    if not (ring.stride(3) == 1 and (p == 1 or ring.stride(2) == c)
            and (aligned or attend_body(ring.dtype, c) == "wide")):
        raise ValueError(f"ring kernel needs rows contiguous (and, but on the "
                         f"general block, frames 16-byte aligned), got strides "
                         f"{ring.stride()}")


def coattention_ring(ring: torch.Tensor, temperature: float, center_t: int,
                     newest_slot=None) -> torch.Tensor:
    """K4 on a CUDA (B, S, P, C) ring: one launch computes the center frame
    (temporal index `center_t`) attended to every reference, -> (B, S-1,
    P, C) in temporal reference order. `newest_slot` is the physical slot
    of the newest frame (None: S - 1), a host integer passed by value.
    Output bf16 for int8 rings, the ring's dtype otherwise. Forward only.
    Raises on what the kernel does not take."""
    _check_ring(ring)
    b, s, p, c = ring.shape
    slot = _newest_slot(s, center_t, newest_slot)
    t = (temperature / (INT8_SCALE * INT8_SCALE) if ring.dtype == torch.int8
         else temperature)
    lib = _ring_lib()
    out = torch.empty((b, s - 1, p, c), dtype=_ring_out_dtype(ring.dtype),
                      device=ring.device)
    with torch.cuda.device(ring.device):
        stream = torch.cuda.current_stream(ring.device).cuda_stream
        err = lib.dcnet_coattn_ring(
            ring.data_ptr(), out.data_ptr(), b, s, p, c, center_t, slot,
            ring.stride(0), ring.stride(1), float(t),
            _RING_DTYPE_CODE[ring.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"ring kernel launch failed (B={b}, S={s}, P={p}, C={c}, "
            f"{ring.dtype}): {lib.dcnet_coattn_ring_error_string(err).decode()}")
    kernels.LAUNCHES["coattn_ring"] += 1
    return out


def coattention_ring_fused(ring: torch.Tensor, temperature: float = 10.0,
                           center_t=None, newest_slot=None) -> torch.Tensor:
    """The dispatch of K4 on an NHWC ring (B, S, H, W, C) -> the STACKED
    (B, S-1, H, W, C) attended features, references in temporal order;
    `center_t` defaults to S // 2. CPU tensors take `ring_attend_plain`;
    CUDA tensors launch the kernel (`coattention_ring`) or raise."""
    b, s, h, w, c = ring.shape
    center_t = s // 2 if center_t is None else center_t
    flat = ring.reshape(b, s, h * w, c)
    if _on_cpu(ring):
        out = ring_attend_plain(flat, temperature, center_t, newest_slot)
    else:
        out = coattention_ring(flat, temperature, center_t, newest_slot)
    return out.reshape(b, s - 1, h, w, c)
