"""K6: the int8 convolution, an NHWC implicit GEMM with a fused epilogue.

No TPU kernel stands behind it: the JAX package runs its int8 convolutions
through XLA (`lax.conv_general_dilated(int8, int8,
preferred_element_type=int32)`, `dcnet_tpu/ops/quant.py:224-227` and
`dcnet_tpu/models/heads.py:93-96`), and PyTorch has no int8 convolution on
CUDA. Three CUDA routes compute it, chosen by `conv_plan` from the shape
and the data's alignment, never as a fallback:

- "tma" (`csrc/conv_s8_tma.cuh`, library `conv_s8_tma.cu`): wgmma s8 on TMA
  tiles, split-K through a cluster's shared memory. It reads int8 x with
  Ci % 16 == 0: a float x, or one whose channels need padding to 16, goes
  first through the quantize pass (`csrc/conv_s8.cuh::quant_pass_kernel`,
  counted as `conv_s8_quant`), and so does w where its channels are padded
  (once for each version of w: the padded copy is kept on w).
- "halo" (`csrc/conv_s8_halo.cuh`): a thin reduction, Ci < 64 or k^2 Ci <
  256 (the first layer's 3 -> 32, the 3x3 32 -> 64s, the 1x1 64 -> 32 and
  128 -> 64: too few iterations for the TMA route's pipeline). Persistent
  blocks walk tiles of 128 output pixels and all of Co; each tile's input
  and halo arrives as one TMA box in x's own type, is quantized once into
  an int8 halo tile in shared memory, and wgmma s8 reads every tap from it
  (A from registers) against the weights, resident in shared memory
  (`halo_plan` gives the tile, the map, the layout and the grid).
- "gather" (`csrc/conv_s8.cuh::conv_s8_kernel`, the first mma.sync kernel):
  the shapes neither takes, no path's: a thin reduction the halo route
  cannot map (x off 16-byte alignment, rows of x that are not 16-byte
  multiples), an int8 x or a w that is not 16-byte aligned and needs no
  padded copy, a stride whose phase views would overlap (an odd height at
  stride 2), more than 64 taps or 16 phase maps.

The halo route, the gather route and the pass are built as one library
per input type (`csrc/conv_s8.cu`, `conv_s8_bf16.cu`, `conv_s8_fp32.cu`);
the four libraries of K6 build in parallel. `kernels.LAUNCHES` counts the
launches under one key per route (`kernels.CONV_S8_KEYS`).
`conv_s8_plain` is the plain version:
the int32 sums as a float64 product of the im2col matrix with the weights
(every partial sum an integer below 2^53, so exact in any order), then the
same epilogue with each fused multiply-add emulated exactly (`fma32`). CPU
tensors take it; CUDA tensors launch the kernel or raise.

x may be int8, or fp32 / bf16 quantized (by the pass, in the halo tile, or
as the gather route gathers it) with the JAX package's static-scale step:
`clamp(round(x * in_inv), -127, 127)` (the backbone) or
`clamp(round(x / in_scale), -127, 127)` (the trunk, `in_scale` an fp32
0-dim tensor on x's device, a true division).

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
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dcnet_tpu_torch import kernels
from dcnet_tpu_torch.kernels import build

_MODE = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2, torch.int8: 3}
_X_DTYPE = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
SOURCES = {torch.int8: "conv_s8", torch.bfloat16: "conv_s8_bf16",
           torch.float32: "conv_s8_fp32"}   # x's dtype -> csrc/<name>.cu
TMA_SOURCE = "conv_s8_tma"                  # the wgmma s8 + TMA route
ALL_SOURCES = (*SOURCES.values(), TMA_SOURCE)
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


def quant_pass_plain(x: torch.Tensor, cp: int, in_inv: Optional[float] = None,
                     in_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The quantize pass's plain version: `quantize_plain`, then zero
    channels up to cp."""
    q = quantize_plain(x, in_inv, in_scale)
    return F.pad(q, (0, cp - x.shape[-1]))


def conv_s8_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                  pad: int = 0, in_inv: Optional[float] = None,
                  in_scale: Optional[torch.Tensor] = None, **epilogue) -> torch.Tensor:
    """The plain version of `conv_s8`: `quantize_plain`,
    `conv_s8_acc_plain`, then `epilogue_plain`."""
    xq = quantize_plain(x, in_inv, in_scale)
    return epilogue_plain(conv_s8_acc_plain(xq, w, stride, pad), **epilogue)


# --- the plan: route, tiles, stages, split and tensor maps by shape --------

SMS = 132                 # the H100 SXM's SMs: a wave is one block an SM
SMEM_LIMIT = 232448       # shared memory a block may use
TMA_ROWS = 128            # output pixels of a block (two warpgroups of 64)
MAX_MAPS, MAX_TAPS, MAX_SPLITS, MAX_STAGES = 16, 64, 8, 8
# the order of the plan array's fields, csrc/conv_s8_tma.cuh::tma::Field
TMA_FIELDS = ("nmaps", "ntaps", "cbox", "bn", "wv", "hv", "nv", "bw",
              "bh", "bimg", "tiles_w", "tiles_h", "tiles_n", "co", "cblocks", "kiters",
              "splits", "stages", "smem", "b_dim0", "b_dim1", "b_stride1", "b_stride2")


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


@dataclass(frozen=True)
class ConvPlan:
    """One convolution's route and, on the TMA and halo routes, everything
    the entry encodes and launches (`conv_plan`)."""
    route: str                      # "tma", "halo" or "gather"
    why: str                        # the shape rule that chose it
    ho: int
    wo: int
    cp: int = 0                     # channels of the int8 operands (Ci rounded up to 16)
    quant_x: bool = False           # x goes through the quantize pass first
    pad_w: bool = False             # w goes through it too (channels padded)
    cbox: int = 0                   # channels (bytes) of a box and its swizzle: 64 or 128
    bn: int = 0                     # output channels of a block
    wv: int = 0                     # the output as the tiles see it: (nv, hv, wv)
    hv: int = 0
    nv: int = 0
    bw: int = 0                     # a block's rectangle of output pixels
    bh: int = 0
    bimg: int = 0
    tiles_w: int = 0
    tiles_h: int = 0
    tiles_n: int = 0
    co: int = 0
    cblocks: int = 0                # boxes of channels a tap
    kiters: int = 0                 # (tap, channel box) iterations of the reduction
    splits: int = 1
    stages: int = 0
    smem: int = 0
    # x's phase maps: (byte offset of the view, dims (Cp, W', H', N), strides
    # of dims 1..3 in bytes); the box is (cbox, bw, bh, bimg)
    a_maps: Tuple = ()
    taps: Tuple = ()                # per tap (r, c): (phase map, dw, dh)
    b_dims: Tuple = ()              # w as (Cp, k k, Co), box (cbox, 1, bn)
    b_strides: Tuple = ()
    halo: Optional["HaloPlan"] = None   # the halo route's launch (`halo_plan`)

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.tiles_w * self.tiles_h * self.tiles_n, -(-self.co // self.bn),
                self.splits)

    def split_range(self, split: int) -> Tuple[int, int]:
        """The iterations [begin, end) split `split` sums, as the kernel
        divides them."""
        return (self.kiters * split // self.splits,
                self.kiters * (split + 1) // self.splits)

    def array(self) -> "ctypes.Array":
        """The int64 plan array the entry reads: on the halo route
        HALO_FIELDS; on the TMA route TMA_FIELDS, then 8 numbers a phase map,
        then 3 a tap."""
        if self.halo is not None:
            return self.halo.array()
        fields = dict(nmaps=len(self.a_maps), ntaps=len(self.taps),
                      b_dim0=self.b_dims[0], b_dim1=self.b_dims[1],
                      b_stride1=self.b_strides[0], b_stride2=self.b_strides[1])
        vals = [fields[f] if f in fields else getattr(self, f) for f in TMA_FIELDS]
        for off, dims, strides in self.a_maps:
            vals += [off, *dims, *strides]
        for t in self.taps:
            vals += list(t)
        return (ctypes.c_longlong * len(vals))(*vals)


# --- the halo route (csrc/conv_s8_halo.cuh) -----------------------------------

HALO_ROWS = 128            # output pixels of a tile
HALO_STAGES = 4            # raw slots of the ring at most (halo::kMaxStages)
SM_SMEM = 233472           # shared memory of an SM; each block also reserves 1 KB
BOX_MAX = 256              # elements of a TMA box along one dimension
_ITEMSIZE = {"int8": 1, "bfloat16": 2, "float32": 4}
# the order of the plan array's fields, csrc/conv_s8_halo.cuh::halo::Field
HALO_FIELDS = ("kind", "d0", "d1", "d2", "d3", "s1", "s2", "s3", "b0", "b1", "b2",
               "box_bytes", "ci", "cp", "k", "stride", "pad", "th", "tw", "hin", "win",
               "row_elems", "lead", "rpitch", "ppitch", "kp", "hv", "wv", "nv",
               "tiles_w", "tiles_h", "tiles", "co", "nchunk", "cochunks", "stages",
               "grid", "smem", "raw_bytes", "off_halo", "off_w", "off_consts", "off_tbl",
               "off_out", "out_es", "off_bar")


@dataclass(frozen=True)
class HaloPlan:
    """One launch of the halo route: x's tensor map (kind 0: (Ci, W, H, N);
    1: each image row flat, (W Ci, H, N, 1); dims d in elements, strides s
    of dims 1..3 in bytes, box b of dims 0..2, `lead` elements of a row
    box before the halo's first pixel), the tile of th x tw output pixels
    and its halo hin x win, the int8 halo tile (Cp channels a pixel, ppitch
    bytes between pixels, rpitch pixels a row), the reduction kp bytes (k^2
    Cp to 32), the output (nv, hv, wv) and its tiles, Co in passes of
    nchunk columns, the ring of `stages` raw slots, the persistent grid and
    the shared-memory layout (byte offsets after the raw slots; 1 KB to
    align them; the staged output sized for outputs of out_es bytes)."""
    kind: int
    d0: int
    d1: int
    d2: int
    d3: int
    s1: int
    s2: int
    s3: int
    b0: int
    b1: int
    b2: int
    box_bytes: int
    ci: int
    cp: int
    k: int
    stride: int
    pad: int
    th: int
    tw: int
    hin: int
    win: int
    row_elems: int
    lead: int
    rpitch: int
    ppitch: int
    kp: int
    hv: int
    wv: int
    nv: int
    tiles_w: int
    tiles_h: int
    tiles: int
    co: int
    nchunk: int
    cochunks: int
    stages: int
    grid: int
    smem: int
    raw_bytes: int
    off_halo: int
    off_w: int
    off_consts: int
    off_tbl: int
    off_out: int
    out_es: int
    off_bar: int

    def array(self) -> "ctypes.Array":
        vals = [getattr(self, f) for f in HALO_FIELDS]
        return (ctypes.c_longlong * len(vals))(*vals)

    def tile_origin(self, t: int) -> Tuple[int, int, int]:
        """Tile t's (image, first output row, first output column)."""
        return (t // (self.tiles_w * self.tiles_h), (t // self.tiles_w) % self.tiles_h * self.th,
                t % self.tiles_w * self.tw)

    def box_coords(self, t: int) -> Tuple[int, int, int, int]:
        """Where tile t's TMA box starts in the map, as the kernel asks."""
        img, oh, ow = self.tile_origin(t)
        wi0, hi0 = ow * self.stride - self.pad, oh * self.stride - self.pad
        return ((0, wi0, hi0, img) if self.kind == 0
                else (wi0 * self.ci - self.lead, hi0, img, 0))

    def tap_offsets(self) -> list:
        """The halo tile offset (tap's pixel offset times ppitch, plus the
        channel) of each 4-byte word of the reduction, (tap, channel) order;
        0 past k^2 taps."""
        out = []
        for kk in range(0, self.kp, 4):
            tap, ch = divmod(kk, self.cp)
            out.append(((tap // self.k) * self.rpitch + tap % self.k) * self.ppitch + ch
                       if tap < self.k * self.k else 0)
        return out


def halo_per_sm(nchunk: int) -> int:
    """Persistent blocks an SM the halo kernel is compiled for (its launch
    bounds, halo::kMinBlocks): three at 32 columns a pass, two at 64."""
    return 3 if nchunk == 32 else 2


def _round(v: int, m: int) -> int:
    return -(-v // m) * m


def halo_plan(n: int, h: int, w: int, ci: int, co: int, k: int, stride: int, pad: int,
              itemsize: int, x_aligned: bool = True, out_itemsize: int = 4):
    """The halo route's launch for a thin reduction (`HaloPlan`; x of
    `itemsize` bytes an element, outputs of `out_itemsize` bytes or
    fewer), or None and the reason it cannot map it. A pure function of
    its arguments."""
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    if not x_aligned:
        return None, "and x not 16-byte aligned (the halo route's tensor map)"
    pix = ci * itemsize
    if k == 1 and stride == 1 and pad == 0 and pix % 16 == 0:
        # 128 consecutive pixels of the flattened output
        kind, th, tw, hv, wv, nv = 0, 1, HALO_ROWS, 1, n * ho * wo, 1
        dims, strides = (ci, n * h * w, 1, 1), (pix, n * h * w * pix, n * h * w * pix)
        hin, win, box = 1, HALO_ROWS, (ci, HALO_ROWS, 1)
        row_elems, lead = HALO_ROWS * ci, 0
    else:
        hv, wv, nv = ho, wo, n
        if pix % 16 == 0:
            kind, tw_min = 0, 1
        elif (w * pix) % 16 == 0:
            # a row map's box starts on a 16-byte multiple (TMA's rule for
            # the innermost coordinate): `lead` elements before the halo's
            # first pixel, the same for every tile as tw s Ci is a multiple
            # of 16 bytes
            kind, tw_min = 1, 16 // math.gcd(stride * pix, 16)
            lead = (-pad * pix) % 16 // itemsize
        else:
            return None, "and rows of x not a multiple of 16 bytes (the halo route's map)"

        def box0(tw):   # the box's innermost dim: the halo's row (kind 0: a pixel)
            return ci if kind == 0 else _round(lead + ((tw - 1) * stride + k) * ci,
                                               16 // itemsize)
        tw = max(tw_min, min(16, _pow2_ceil(wo)))
        while tw > tw_min and ((tw - 1) * stride + k > BOX_MAX or box0(tw) > BOX_MAX):
            tw //= 2
        th = HALO_ROWS // tw
        hin, win = (th - 1) * stride + k, (tw - 1) * stride + k
        if th < 1 or win > BOX_MAX or box0(tw) > BOX_MAX or hin > BOX_MAX:
            return None, "and a halo wider than a tensor map's box"
        if kind == 0:
            dims, strides = (ci, w, h, n), (pix, w * pix, h * w * pix)
            box, row_elems, lead = (ci, win, hin), win * ci, 0
        else:
            dims, strides = (w * ci, h, n, 1), (w * pix, h * w * pix, n * h * w * pix)
            box, row_elems = (box0(tw), hin, 1), box0(tw)
    cp = max(4, _pow2_ceil(ci))
    # the eight rows of an mma fragment in distinct banks: Cp = 4, rows 16
    # pixels past a multiple of 32 words (a step's four words are four
    # taps); Cp >= 32, pixels Cp + 16 bytes apart
    rpitch = win + (16 - win) % 32 if cp == 4 else win
    ppitch = cp + 16 if cp >= 32 else cp
    kp = _round(k * k * cp, 32)
    nchunk = 32 if co <= 32 else 64
    cochunks = -(-co // nchunk)
    tiles_w, tiles_h = -(-wv // tw), -(-hv // th)
    tiles = tiles_w * tiles_h * nv
    box_bytes = box[0] * box[1] * box[2] * itemsize
    raw_bytes = _round(box_bytes, 1024)
    rows = cochunks * nchunk
    # the int8 halo tile; the staged output over it where one pass covers Co
    # (the kernel syncs between the products and the epilogue), else after it
    halo_bytes = _round(hin * rpitch * ppitch, 128)
    out_bytes = HALO_ROWS * (out_itemsize * nchunk + 16)
    shared = cochunks == 1
    sizes = (max(halo_bytes, out_bytes) if shared else halo_bytes + out_bytes,
             _round(rows * kp, 128),           # w (wgmma's core matrices)
             _round(16 * rows, 128),           # scale, bias, scale2, bias2
             _round(kp, 128))                  # the tap offsets (kp / 4 ints)
    # the deepest ring (HALO_STAGES at most) that leaves the blocks an SM
    # the kernel is compiled for, else fewer
    for per_sm, stages in [(p, st) for p in range(halo_per_sm(nchunk), 0, -1)
                           for st in range(HALO_STAGES, 0, -1)]:
        offs = [stages * raw_bytes]
        for size in sizes:
            offs.append(offs[-1] + size)
        smem = offs[-1] + 8 * stages + 1024
        if smem <= SMEM_LIMIT and per_sm * (smem + 1024) <= SM_SMEM:
            break
    else:
        return None, "and a halo tile and weights past shared memory"
    return HaloPlan(
        kind=kind, d0=dims[0], d1=dims[1], d2=dims[2], d3=dims[3], s1=strides[0],
        s2=strides[1], s3=strides[2], b0=box[0], b1=box[1], b2=box[2], box_bytes=box_bytes,
        ci=ci, cp=cp, k=k, stride=stride, pad=pad, th=th, tw=tw, hin=hin, win=win,
        row_elems=row_elems, lead=lead, rpitch=rpitch, ppitch=ppitch, kp=kp, hv=hv, wv=wv,
        nv=nv, tiles_w=tiles_w, tiles_h=tiles_h, tiles=tiles, co=co, nchunk=nchunk,
        cochunks=cochunks, stages=stages, grid=min(tiles, SMS * per_sm), smem=smem,
        raw_bytes=raw_bytes, off_halo=offs[0], off_w=offs[1], off_consts=offs[2],
        off_tbl=offs[3], off_out=offs[0] if shared else offs[0] + halo_bytes,
        out_es=out_itemsize, off_bar=offs[4]), ""


def _smem(stages: int, bn: int, cbox: int) -> int:
    """Dynamic shared memory of a TMA block: the ring (or the staged int32
    tile, the larger), 1 KB to align it, the mbarriers."""
    ring = stages * (TMA_ROWS + bn) * cbox
    return max(ring, TMA_ROWS * (bn + 4) * 4) + 1024 + 16 * stages


@functools.lru_cache(maxsize=4096)
def conv_plan(n: int, h: int, w: int, ci: int, co: int, k: int, stride: int, pad: int,
              x_dtype: str = "int8", x_aligned: bool = True,
              w_aligned: bool = True, out_itemsize: int = 4) -> ConvPlan:
    """How K6 computes the convolution of x (n, h, w, ci) (`x_dtype` "int8",
    "bfloat16" or "float32"; `x_aligned` / `w_aligned`: the data 16-byte
    aligned) with w (co, k, k, ci), stride, pad: the route; on the TMA
    route the quantize pass, the tiles, the split, the stages and the
    tensor maps (module doc, `csrc/conv_s8_tma.cuh`); on the halo route
    `halo_plan`'s launch, its staged output sized for outputs of
    `out_itemsize` bytes or fewer. A pure function of its arguments."""
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    cp = -(-ci // 16) * 16
    quant_x, pad_w = x_dtype != "int8" or cp != ci, cp != ci
    flat = k == 1 and stride == 1 and pad == 0
    rows = sorted({(r - pad) % stride for r in range(k)})
    cols = sorted({(c - pad) % stride for c in range(k)})
    hs = {rr: -(-(h - rr) // stride) for rr in rows}
    ws = {cc: -(-(w - cc) // stride) for cc in cols}
    if ci < 64 or k * k * ci < 256:
        halo, why = halo_plan(n, h, w, ci, co, k, stride, pad, _ITEMSIZE[x_dtype], x_aligned,
                              out_itemsize)
        if halo is not None:
            return ConvPlan("halo", "a thin reduction (Ci < 64 or k^2 Ci < 256) on halo tiles",
                            ho, wo, co=co, halo=halo)
        return ConvPlan("gather", f"a thin reduction (Ci < 64 or k^2 Ci < 256) {why}", ho, wo)
    if not (x_aligned or quant_x) or not (w_aligned or pad_w):
        return ConvPlan("gather", "an int8 operand not 16-byte aligned", ho, wo)
    if k * k > MAX_TAPS or (not flat and len(rows) * len(cols) > MAX_MAPS):
        return ConvPlan("gather", "more taps or phase maps than the kernel takes", ho, wo)
    if not flat and any(v < 1 or v * stride > h for v in hs.values()):
        return ConvPlan("gather", "a phase view of x past the image (odd side at the "
                                  "stride)", ho, wo)
    if not flat and any(v < 1 for v in ws.values()):
        return ConvPlan("gather", "an empty phase view of x", ho, wo)
    cbox = 64 if cp <= 64 else 128
    cblocks = -(-cp // cbox)
    if flat:
        wv, hv, nv, bw, bh, bimg = n * ho * wo, 1, 1, TMA_ROWS, 1, 1
        a_maps = ((0, (cp, n * h * w, 1, 1), (cp, n * h * w * cp, n * h * w * cp)),)
        taps = ((0, 0, 0),)
    else:
        wv, hv, nv = wo, ho, n
        bw = min(_pow2_ceil(wo), TMA_ROWS)
        bh = min(_pow2_ceil(ho), TMA_ROWS // bw)
        bimg = TMA_ROWS // (bw * bh)
        a_maps = tuple(((rr * w + cc) * cp, (cp, ws[cc], hs[rr], n),
                        (stride * cp, stride * w * cp, h * w * cp))
                       for rr in rows for cc in cols)
        taps = []
        for r in range(k):
            for c in range(k):
                (qr, rr), (qc, cc) = divmod(r - pad, stride), divmod(c - pad, stride)
                taps.append((rows.index(rr) * len(cols) + cols.index(cc), qc, qr))
        taps = tuple(taps)
    tiles_w, tiles_h, tiles_n = -(-wv // bw), -(-hv // bh), -(-nv // bimg)
    mtiles = tiles_w * tiles_h * tiles_n
    kiters = k * k * cblocks
    # a block's columns: the widest of 256 / 128 / 64 that Co needs and that
    # leaves a quarter wave of tiles, else 64; then split-K while the grid
    # stays within a wave and each split keeps 4 iterations (the tiles and
    # splits `kernel_timing.py --k6-plans` measured fastest, PERF.md section 6)
    bn = 64
    for cand in (256, 128):
        if co > cand // 2 and mtiles * -(-co // cand) >= SMS // 4:
            bn = cand
            break
    tiles = mtiles * -(-co // bn)
    splits = 1
    while (splits < MAX_SPLITS and tiles * splits * 2 <= SMS
           and kiters >= 4 * splits * 2):
        splits *= 2
    stage = (TMA_ROWS + bn) * cbox
    stages = max(2, min(MAX_STAGES, (SMEM_LIMIT - 1024 - 16 * MAX_STAGES) // stage))
    return ConvPlan(
        "tma", "wgmma s8 + TMA" + (" after the quantize pass" if quant_x else ""),
        ho, wo, cp=cp, quant_x=quant_x, pad_w=pad_w, cbox=cbox, bn=bn,
        wv=wv, hv=hv, nv=nv, bw=bw, bh=bh, bimg=bimg, tiles_w=tiles_w, tiles_h=tiles_h,
        tiles_n=tiles_n, co=co, cblocks=cblocks, kiters=kiters, splits=splits,
        stages=stages, smem=_smem(stages, bn, cbox), a_maps=a_maps, taps=taps,
        b_dims=(cp, k * k, co), b_strides=(cp, k * k * cp))


def plan_for(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int,
             out_dtype: torch.dtype = torch.int32) -> ConvPlan:
    """`conv_plan` for these tensors and an output of `out_dtype`."""
    n, h, wd, ci = x.shape
    return conv_plan(n, h, wd, ci, w.shape[0], w.shape[1], stride, pad,
                     str(x.dtype).replace("torch.", ""), x.data_ptr() % 16 == 0,
                     w.data_ptr() % 16 == 0, torch.empty((), dtype=out_dtype).element_size())


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
    """The library of K6's halo route, gather route and quantize pass for
    inputs of `x_dtype`, built first if needed."""
    lib = build.load(SOURCES[x_dtype])
    if not getattr(lib, "_dcnet_bound", False):
        lib.dcnet_conv_s8.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float]
            + [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 + [ctypes.c_float]
            + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.dcnet_conv_s8.restype = ctypes.c_int
        lib.dcnet_conv_s8_quant.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.dcnet_conv_s8_quant.restype = ctypes.c_int
        lib.dcnet_conv_s8_halo.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float]
            + [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 + [ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
        lib.dcnet_conv_s8_halo.restype = ctypes.c_int
        lib.dcnet_conv_s8_error_string.argtypes = [ctypes.c_int]
        lib.dcnet_conv_s8_error_string.restype = ctypes.c_char_p
        lib._dcnet_bound = True
    return lib


def _tma_lib() -> ctypes.CDLL:
    """The library of K6's TMA route, built first if needed."""
    lib = build.load(TMA_SOURCE)
    if not getattr(lib, "_dcnet_bound", False):
        lib.dcnet_conv_s8_tma.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 + [ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
        lib.dcnet_conv_s8_tma.restype = ctypes.c_int
        lib.dcnet_conv_s8_tma_error_string.argtypes = [ctypes.c_int]
        lib.dcnet_conv_s8_tma_error_string.restype = ctypes.c_char_p
        lib._dcnet_bound = True
    return lib


def quant_pass(x: torch.Tensor, cp: int, in_inv: Optional[float] = None,
               in_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The quantize pass on the card: x (..., Ci) contiguous, int8 (copied)
    or fp32 / bf16 (quantized, `quantize_plain`), into an int8 (..., cp)
    copy whose channels past Ci are zero. Counted as `conv_s8_quant`. A CPU
    tensor takes `quant_pass_plain`. It is the `dcnet::conv_s8_quant` op."""
    return quant_pass_op(x, cp, in_inv, in_scale)


def _quant_pass_launch(x: torch.Tensor, cp: int, in_inv: Optional[float],
                       in_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of the quantize pass (`quant_pass_kernel`), counted."""
    ci = x.shape[-1]
    out = torch.empty((*x.shape[:-1], cp), dtype=torch.int8, device=x.device)
    lib = _lib(x.dtype)
    qmode = 0 if x.dtype == torch.int8 else (1 if in_scale is None else 2)
    with torch.cuda.device(x.device):
        err = lib.dcnet_conv_s8_quant(
            x.data_ptr(), _X_DTYPE[x.dtype], qmode,
            float(in_inv) if in_inv is not None else 0.0,
            None if in_scale is None else in_scale.data_ptr(), out.data_ptr(),
            x.numel() // ci, ci, cp, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 conv quantize pass failed (x {tuple(x.shape)} {x.dtype}, "
                           f"cp {cp}): {lib.dcnet_conv_s8_error_string(err).decode()}")
    kernels.LAUNCHES["conv_s8_quant"] += 1
    return out


def pad_w_due(w: torch.Tensor, cp: int) -> bool:
    """Whether a TMA launch that pads w's channels to cp runs the quantize
    pass on w: w holds no padded copy of its current version (an
    inference tensor, which has no version counter, keeps none)."""
    if w.is_inference():
        return True
    kept = getattr(w, "_k6_padded", None)
    return kept is None or kept[0] != (w._version, cp)


def _padded_w(w: torch.Tensor, cp: int) -> torch.Tensor:
    """w with its channels zero-padded to cp by the quantize pass, made
    once for each version of w and kept on w: a path's constant weights
    are padded at their first call, not at every call."""
    if w.is_inference():
        return quant_pass(w, cp)
    if pad_w_due(w, cp):
        w._k6_padded = ((w._version, cp), quant_pass(w, cp))
    return w._k6_padded[1]


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
    "leaky". It is the `dcnet::conv_s8` op: CPU tensors take
    `conv_s8_plain`; CUDA tensors launch the kernel on the current stream
    (the route `conv_plan` picks) or raise."""
    if (scale is None) != (out_dtype == torch.int32) or (scale is None) != (bias is None) \
            or (scale2 is None) != (bias2 is None) or act not in _ACT:
        raise ValueError("conv_s8: int32 output takes no scale; a scale needs a bias, "
                         "scale2 needs bias2, act is None, 'relu' or 'leaky'")
    return conv_s8_op(x, w, stride, pad, scale, bias, scale2, bias2, act, out_dtype,
                      inv_out, addend, addend_hw, addend_rep, in_inv, in_scale)


def _conv_s8_dispatch(x, w, stride, pad, scale, bias, scale2, bias2, act, out_dtype,
                      inv_out, addend, addend_hw, addend_rep, in_inv, in_scale):
    """The real implementation of `dcnet::conv_s8`: the plain version on
    the CPU, else the checks, the plan and one route's launch."""
    epilogue = dict(scale=scale, bias=bias, scale2=scale2, bias2=bias2, act=act,
                    out_dtype=out_dtype, inv_out=inv_out, addend=addend,
                    addend_hw=addend_hw, addend_rep=addend_rep)
    if x.device.type == "cpu" and w.device.type == "cpu":  # in the kernel's layout
        return conv_s8_plain(x, w, stride, pad, in_inv=in_inv, in_scale=in_scale,
                             **epilogue).contiguous()
    floats = (scale, bias, scale2, bias2)
    _check(x, w, stride, pad, floats, addend, out_dtype, inv_out, in_inv, in_scale)
    plan = plan_for(x, w, stride, pad, out_dtype)
    if plan.route == "tma":
        return _conv_tma(plan, x, w, floats, addend, addend_hw, addend_rep, out_dtype,
                         inv_out, act, in_inv, in_scale)
    if plan.route == "halo":
        return _conv_halo(plan, x, w, floats, addend, addend_hw, addend_rep, out_dtype,
                          inv_out, act, in_inv, in_scale)
    return _conv_gather(plan, x, w, stride, pad, floats, addend, addend_hw, addend_rep,
                        out_dtype, inv_out, act, in_inv, in_scale)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _conv_tma(plan: ConvPlan, x, w, floats, addend, addend_hw, addend_rep, out_dtype,
              inv_out, act, in_inv, in_scale, plan_array=None) -> torch.Tensor:
    """The TMA route: the quantize pass where the plan asks for it, then
    one launch of the wgmma kernel (`plan_array` replaces the plan's own
    array: the tests hand it a map the CUDA driver refuses)."""
    xq = quant_pass(x, plan.cp, in_inv, in_scale) if plan.quant_x else x
    wq = _padded_w(w, plan.cp) if plan.pad_w else w
    n = x.shape[0]
    out = torch.empty((n, plan.ho, plan.wo, plan.co), dtype=out_dtype, device=x.device)
    lib = _tma_lib()
    with torch.cuda.device(x.device):
        err = lib.dcnet_conv_s8_tma(
            xq.data_ptr(), wq.data_ptr(), out.data_ptr(), *[_ptr(t) for t in floats],
            _ptr(addend), addend_hw, addend_rep,
            float(inv_out) if inv_out is not None else 0.0, _MODE[out_dtype], _ACT[act],
            plan_array if plan_array is not None else _plan_array(plan),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"int8 conv kernel (tma route) launch failed (x {tuple(x.shape)} {x.dtype}, "
            f"w {tuple(w.shape)}, {out_dtype}, bn {plan.bn}, splits {plan.splits}, "
            f"stages {plan.stages}): {lib.dcnet_conv_s8_tma_error_string(err).decode()}")
    kernels.LAUNCHES["conv_s8"] += 1
    return out


@functools.lru_cache(maxsize=4096)
def _plan_array(plan: ConvPlan):
    return plan.array()


def _conv_halo(plan: ConvPlan, x, w, floats, addend, addend_hw, addend_rep, out_dtype,
               inv_out, act, in_inv, in_scale, plan_array=None) -> torch.Tensor:
    """The halo route: one launch of the persistent halo-tile kernel, x
    read in its own type and quantized in shared memory (`plan_array`
    replaces the plan's own array: the tests hand it a map the CUDA driver
    refuses)."""
    out = torch.empty((x.shape[0], plan.ho, plan.wo, plan.co), dtype=out_dtype,
                      device=x.device)
    lib = _lib(x.dtype)
    qmode = 0 if x.dtype == torch.int8 else (1 if in_scale is None else 2)
    with torch.cuda.device(x.device):
        err = lib.dcnet_conv_s8_halo(
            x.data_ptr(), _X_DTYPE[x.dtype], qmode,
            float(in_inv) if in_inv is not None else 0.0, _ptr(in_scale), w.data_ptr(),
            out.data_ptr(), *[_ptr(t) for t in floats], _ptr(addend), addend_hw, addend_rep,
            float(inv_out) if inv_out is not None else 0.0, _MODE[out_dtype], _ACT[act],
            plan_array if plan_array is not None else _plan_array(plan),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        hp = plan.halo
        raise RuntimeError(
            f"int8 conv kernel (halo route) launch failed (x {tuple(x.shape)} {x.dtype}, "
            f"w {tuple(w.shape)}, {out_dtype}, tile {hp.th}x{hp.tw}, stages {hp.stages}, "
            f"grid {hp.grid}): {lib.dcnet_conv_s8_error_string(err).decode()}")
    kernels.LAUNCHES["conv_s8_halo"] += 1
    return out


def _conv_gather(plan: ConvPlan, x, w, stride, pad, floats, addend, addend_hw,
                 addend_rep, out_dtype, inv_out, act, in_inv, in_scale) -> torch.Tensor:
    """The gather route: the first mma.sync kernel, quantizing a float x as it
    gathers it (the thin shapes the halo route cannot map, and the others
    the TMA route cannot take)."""
    n, h, wd, ci = x.shape
    co, k = w.shape[0], w.shape[1]
    out = torch.empty((n, plan.ho, plan.wo, co), dtype=out_dtype, device=x.device)
    vec = conv_vec(ci, x, w)
    lib = _lib(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        qmode = 0 if x.dtype == torch.int8 else (1 if in_scale is None else 2)
        err = lib.dcnet_conv_s8(
            x.data_ptr(), _X_DTYPE[x.dtype], qmode,
            float(in_inv) if in_inv is not None else 0.0, _ptr(in_scale),
            w.data_ptr(), out.data_ptr(), *[_ptr(t) for t in floats],
            _ptr(addend), addend_hw, addend_rep,
            float(inv_out) if inv_out is not None else 0.0,
            n, h, wd, ci, co, k, stride, pad, _MODE[out_dtype], _ACT[act], vec, stream)
    if err != 0:
        raise RuntimeError(
            f"int8 conv kernel (gather route) launch failed (x {tuple(x.shape)} {x.dtype}, "
            f"w {tuple(w.shape)}, "
            f"stride {stride}, pad {pad}, {out_dtype}, vec {vec}): "
            f"{lib.dcnet_conv_s8_error_string(err).decode()}")
    kernels.LAUNCHES["conv_s8_gather"] += 1
    return out


# --------------------------------------------------------------------------
# Registered operators: K6 and its quantize pass as `torch.ops.dcnet.*`
# --------------------------------------------------------------------------

def _refuse_meta(*xs: Optional[torch.Tensor]) -> None:
    """A real meta tensor (not a fake one under tracing) lies on no device
    the kernel runs on: refuse it, as the CUDA path refuses it."""
    xs = [t for t in xs if t is not None]
    if any(t.device.type == "meta" for t in xs):
        raise ValueError(f"int8 conv kernel needs every tensor on one CUDA device, "
                         f"got {', '.join(str(t.device) for t in xs)}")


@torch.library.custom_op("dcnet::conv_s8", mutates_args=())
def conv_s8_op(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int,
               scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
               scale2: Optional[torch.Tensor], bias2: Optional[torch.Tensor],
               act: Optional[str], out_dtype: torch.dtype, inv_out: Optional[float],
               addend: Optional[torch.Tensor], addend_hw: int, addend_rep: int,
               in_inv: Optional[float], in_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """K6, one operator over its three routes (`conv_s8`'s arguments)."""
    return _conv_s8_dispatch(x, w, stride, pad, scale, bias, scale2, bias2, act,
                             out_dtype, inv_out, addend, addend_hw, addend_rep, in_inv,
                             in_scale)


@conv_s8_op.register_fake
def _conv_s8_fake(x, w, stride, pad, scale, bias, scale2, bias2, act, out_dtype,
                  inv_out, addend, addend_hw, addend_rep, in_inv, in_scale):
    _refuse_meta(x, w, scale, bias, scale2, bias2, addend, in_scale)
    n, h, wd, _ = x.shape
    k = w.shape[1]
    ho, wo = (h + 2 * pad - k) // stride + 1, (wd + 2 * pad - k) // stride + 1
    return x.new_empty((n, ho, wo, w.shape[0]), dtype=out_dtype)


@torch.library.custom_op("dcnet::conv_s8_quant", mutates_args=())
def quant_pass_op(x: torch.Tensor, cp: int, in_inv: Optional[float],
                  in_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """K6's quantize pass (`quant_pass`)."""
    if x.device.type == "cpu":
        return quant_pass_plain(x, cp, in_inv, in_scale)
    return _quant_pass_launch(x, cp, in_inv, in_scale)


@quant_pass_op.register_fake
def _quant_pass_fake(x, cp, in_inv, in_scale):
    _refuse_meta(x, in_scale)
    return x.new_empty((*x.shape[:-1], cp), dtype=torch.int8)
