"""Darknet-53 / YOLOv3 backbone (PyTorch, NHWC at the boundary).

The port of `dcnet_tpu/models/darknet.py`: the cfg parser and layer list
(`LayerDef`, `parse_darknet_cfg`, `yolov3_layer_defs`, `mini_backbone_defs`),
the exact expand-reshape x2 upsample, the backbone that captures the three
maps BEFORE each `yoloconvolutional` conv (coarsest first), and the binary
`.weights` reader/writer. Parameters sit in the reference key namespace
`visumodel.module_list.{i}.conv_{i}` / `batch_norm_{i}`, so the `.weights`
reader writes straight into the port's state_dict (Darknet already stores
kernels as (out, in, kh, kw)).

Activations are NHWC tensors; each convolution runs on the channels-last
NCHW view of them (`heads.conv_nhwc`), so no layout copy is made. In eval
each BatchNorm conv's epilogue (BatchNorm on the running statistics, leaky
ReLU and, where a shortcut adds to the conv's output alone, the add) is
one pass, `heads.bn_eval_act` (kernel K7 on the card).
"""

from __future__ import annotations

import dataclasses
import io
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dcnet_tpu_torch.models.heads import bn_eval_act, bn_train, conv_nhwc, leaky_relu


@dataclasses.dataclass(frozen=True)
class LayerDef:
    """One parsed cfg block (everything after [net])."""

    type: str
    filters: int = 0
    size: int = 0
    stride: int = 1
    pad: int = 0
    batch_normalize: bool = False
    activation: str = "linear"
    layers: Tuple[int, ...] = ()   # route sources
    from_: int = 0                 # shortcut source
    in_filters: int = 0            # derived: conv input channels
    out_filters: int = 0           # derived: block output channels


def parse_darknet_cfg(path_or_text: str) -> Tuple[Dict[str, str], Tuple[LayerDef, ...]]:
    """Parse a Darknet INI cfg (a path, or the text itself) into
    (net hyperparams, static layer list with channel counts)."""
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    blocks: List[Dict[str, str]] = []
    for line in text.split("\n"):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            blocks.append({"type": line[1:-1].strip()})
        else:
            k, v = line.split("=", 1)
            blocks[-1][k.strip()] = v.strip()
    net = blocks.pop(0)
    assert net["type"] == "net"
    return net, _blocks_to_defs(blocks, int(net.get("channels", 3)))


def _blocks_to_defs(blocks: Sequence[Dict[str, str]], channels: int) -> Tuple[LayerDef, ...]:
    out_filters = [channels]
    defs: List[LayerDef] = []
    for b in blocks:
        t = b["type"]
        if t in ("convolutional", "yoloconvolutional"):
            filters = int(b["filters"])
            ld = LayerDef(
                type=t, filters=filters, size=int(b["size"]),
                stride=int(b.get("stride", 1)),
                pad=(int(b["size"]) - 1) // 2 if int(b.get("pad", 0)) else 0,
                batch_normalize=bool(int(b.get("batch_normalize", 0))),
                activation=b.get("activation", "linear"),
                in_filters=out_filters[-1], out_filters=filters)
        elif t == "maxpool":
            ld = LayerDef(type=t, size=int(b["size"]), stride=int(b["stride"]),
                          out_filters=out_filters[-1])
        elif t == "upsample":
            assert int(b["stride"]) == 2, "only x2 upsample supported"
            ld = LayerDef(type=t, stride=2, out_filters=out_filters[-1])
        elif t == "route":
            srcs = tuple(int(x) for x in b["layers"].split(","))
            # python-style indexing into the per-layer output list
            ld = LayerDef(type=t, layers=srcs,
                          out_filters=sum(out_filters[1:][s] for s in srcs))
        elif t == "shortcut":
            ld = LayerDef(type=t, from_=int(b["from"]),
                          activation=b.get("activation", "linear"),
                          out_filters=out_filters[1:][int(b["from"])])
        elif t == "yolo":
            # placeholder slot: keeps route indexing aligned
            ld = LayerDef(type=t, out_filters=out_filters[-1])
        else:
            raise ValueError(f"unsupported layer type: {t}")
        defs.append(ld)
        out_filters.append(ld.out_filters)
    return tuple(defs)


def yolov3_layer_defs(num_classes: int = 80) -> Tuple[LayerDef, ...]:
    """The 107-layer YOLOv3 list: Darknet-53 trunk (1/2/8/8/4 residual
    blocks) and the 3-scale head, whose third 1x1 conv per scale is marked
    `yoloconvolutional` so the backbone captures [1024 @ /32, 512 @ /16,
    256 @ /8]."""
    blocks: List[Dict[str, str]] = []

    def conv(filters: int, size: int, stride: int = 1, t: str = "convolutional",
             bn: bool = True, act: str = "leaky") -> None:
        blocks.append({
            "type": t, "filters": str(filters), "size": str(size),
            "stride": str(stride), "pad": "1",
            "batch_normalize": "1" if bn else "0", "activation": act})

    def residual(mid: int, out: int) -> None:
        conv(mid, 1)
        conv(out, 3)
        blocks.append({"type": "shortcut", "from": "-3"})

    conv(32, 3)
    for out, n_blocks in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
        conv(out, 3, stride=2)
        for _ in range(n_blocks):
            residual(out // 2, out)

    det_filters = 3 * (5 + num_classes)
    head = ((512, 1024), (256, 512), (128, 256))
    route_back = (None, "61", "36")  # trunk taps for scales 1 and 2
    for s, (mid, out) in enumerate(head):
        if s > 0:
            blocks.append({"type": "route", "layers": "-4"})
            conv(mid, 1)
            blocks.append({"type": "upsample", "stride": "2"})
            blocks.append({"type": "route", "layers": f"-1, {route_back[s]}"})
        for _ in range(2):
            conv(mid, 1)
            conv(out, 3)
        conv(mid, 1, t="yoloconvolutional")
        conv(out, 3)
        conv(det_filters, 1, bn=False, act="linear")
        blocks.append({"type": "yolo"})
    return _blocks_to_defs(blocks, 3)


def mini_backbone_defs() -> Tuple[LayerDef, ...]:
    """A tiny 3-scale backbone with YOLOv3's capture contract (/32, /16, /8,
    coarsest first), for tests and smoke runs."""
    blocks: List[Dict[str, str]] = []

    def conv(filters: int, size: int, stride: int = 1,
             t: str = "convolutional") -> None:
        blocks.append({
            "type": t, "filters": str(filters), "size": str(size),
            "stride": str(stride), "pad": "1", "batch_normalize": "1",
            "activation": "leaky"})

    conv(8, 3, 2)
    conv(16, 3, 2)
    conv(24, 3, 2)
    conv(32, 3, 2)
    conv(48, 3, 2)
    conv(16, 1, t="yoloconvolutional")        # capture 48ch @ /32
    blocks.append({"type": "upsample", "stride": "2"})
    blocks.append({"type": "route", "layers": "-1, 3"})
    conv(16, 1, t="yoloconvolutional")        # capture 48ch @ /16
    blocks.append({"type": "upsample", "stride": "2"})
    blocks.append({"type": "route", "layers": "-1, 2"})
    conv(8, 1, t="yoloconvolutional")         # capture 40ch @ /8
    return _blocks_to_defs(blocks, 3)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Exact nearest x2 of an NHWC map by expand-reshape."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, h * 2, w * 2, c)


def _max_pool_nhwc(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """Darknet maxpool: size 2 / stride 1 pads one row and column at the end,
    everything else pads like XLA's "SAME" (with -inf)."""
    h, w = x.shape[1], x.shape[2]
    if size == 2 and stride == 1:
        pads = (0, 1, 0, 1)
    else:
        def same(n):
            total = max((-(-n // stride) - 1) * stride + size - n, 0)
            return total // 2, total - total // 2
        (top, bottom), (left, right) = same(h), same(w)
        pads = (left, right, top, bottom)
    y = F.pad(x.permute(0, 3, 1, 2), pads, value=float("-inf"))
    return F.max_pool2d(y, size, stride).permute(0, 2, 3, 1)


def _referenced_outputs(defs: Sequence[LayerDef]) -> set:
    """Indices of layer outputs that a later route or shortcut reads."""
    keep = set()
    for i, ld in enumerate(defs):
        srcs = ld.layers if ld.type == "route" else (
            (ld.from_,) if ld.type == "shortcut" else ())
        keep.update(s if s >= 0 else i + s for s in srcs)
    return keep


def _folded_shortcuts(defs: Sequence[LayerDef], keep: set) -> Dict[int, int]:
    """conv layer -> the layer its shortcut adds, for each BatchNorm conv
    that a shortcut follows at once and whose own output nothing else
    reads (not in `keep`): the eval path adds the shortcut in the conv's
    epilogue, and the shortcut layer takes the sum as it is."""
    fold = {}
    for i, ld in enumerate(defs[1:], start=1):
        conv = defs[i - 1]
        if ld.type == "shortcut" and conv.type in ("convolutional", "yoloconvolutional") \
                and conv.batch_normalize and i - 1 not in keep:
            fold[i - 1] = ld.from_ if ld.from_ >= 0 else i + ld.from_
    return fold


class DarknetBackbone(nn.Module):
    """cfg-driven backbone; forward returns the 3 captured NHWC maps
    (coarsest first). `module_list[i]` holds `conv_{i}` (and `batch_norm_{i}`)
    for conv layers and is empty otherwise, as in the reference. BN math
    runs in fp32 and activations are stored in `dtype`; `train` takes the
    batch statistics (torch momentum 0.1, flax's 0.9)."""

    def __init__(self, layer_defs: Sequence[LayerDef], device=None):
        super().__init__()
        self.layer_defs = tuple(layer_defs)
        self.module_list = nn.ModuleList()
        for i, ld in enumerate(self.layer_defs):
            m = nn.Sequential()
            if ld.type in ("convolutional", "yoloconvolutional"):
                m.add_module(f"conv_{i}", nn.Conv2d(
                    ld.in_filters, ld.filters, ld.size, ld.stride, ld.pad,
                    bias=not ld.batch_normalize, device=device))
                if ld.batch_normalize:
                    m.add_module(f"batch_norm_{i}", nn.BatchNorm2d(
                        ld.filters, eps=1e-5, device=device))
            self.module_list.append(m)
        self._keep = _referenced_outputs(self.layer_defs)
        self._fold = _folded_shortcuts(self.layer_defs, self._keep)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                train: bool = False) -> List[torch.Tensor]:
        """x: NHWC images (N, H, W, 3) -> [/32, /16, /8] NHWC maps. In eval
        a BatchNorm conv's BatchNorm, leaky ReLU and folded shortcut add
        (`_folded_shortcuts`) are one `bn_eval_act`."""
        captured: List[torch.Tensor] = []
        saved: Dict[int, torch.Tensor] = {}  # only outputs read again later
        x = x.to(dtype)
        for i, ld in enumerate(self.layer_defs):
            if ld.type in ("convolutional", "yoloconvolutional"):
                if ld.type == "yoloconvolutional":
                    captured.append(x)
                conv = self.module_list[i][0]
                x = conv_nhwc(x, conv.weight, conv.bias, ld.stride, ld.pad)
                if ld.batch_normalize and not train:
                    x = bn_eval_act(x, self.module_list[i][1],
                                    "leaky" if ld.activation == "leaky" else None,
                                    saved[self._fold[i]] if i in self._fold else None)
                else:
                    if ld.batch_normalize:
                        x = bn_train(x, self.module_list[i][1])
                    if ld.activation == "leaky":
                        x = leaky_relu(x)
            elif ld.type == "maxpool":
                x = _max_pool_nhwc(x, ld.size, ld.stride)
            elif ld.type == "upsample":
                x = upsample2(x)
            elif ld.type == "route":
                x = torch.cat([saved[s if s >= 0 else i + s]
                               for s in ld.layers], dim=-1)
            elif ld.type == "shortcut":
                if train or i - 1 not in self._fold:  # else the conv added it
                    s = ld.from_
                    x = x + saved[s if s >= 0 else i + s]
            if i in self._keep:
                saved[i] = x
        return captured


# --------------------------------------------------------------------------
# Binary .weights IO (Darknet layout <-> the reference state_dict keys)
# --------------------------------------------------------------------------

def _conv_key(i: int) -> str:
    return f"visumodel.module_list.{i}.conv_{i}"


def _bn_key(i: int) -> str:
    return f"visumodel.module_list.{i}.batch_norm_{i}"


def load_darknet_weights(
    layer_defs: Sequence[LayerDef], path: str, header_len: int = 5
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Parse a Darknet `.weights` blob into backbone state_dict entries.

    Per conv block, in file order: BN beta, gamma, running_mean,
    running_var (or the conv bias when there is no BN), then the kernel as
    (out, in, kh, kw). Returns ({key: float32 array}, header)."""
    with open(path, "rb") as f:
        header = np.frombuffer(f.read(4 * header_len), dtype=np.int32)
        weights = np.frombuffer(f.read(), dtype=np.float32)
    sd: Dict[str, np.ndarray] = {}
    ptr = 0

    def take(n: int) -> np.ndarray:
        nonlocal ptr
        out = weights[ptr:ptr + n]
        if out.size != n:
            raise ValueError(
                f"weights file exhausted: wanted {n} floats at offset {ptr}, "
                f"have {weights.size - ptr}")
        ptr += n
        return out

    for i, ld in enumerate(layer_defs):
        if ld.type not in ("convolutional", "yoloconvolutional"):
            continue
        c_out, c_in, k = ld.out_filters, ld.in_filters, ld.size
        if ld.batch_normalize:
            for attr in ("bias", "weight", "running_mean", "running_var"):
                sd[f"{_bn_key(i)}.{attr}"] = take(c_out)
        else:
            sd[f"{_conv_key(i)}.bias"] = take(c_out)
        sd[f"{_conv_key(i)}.weight"] = take(c_out * c_in * k * k).reshape(
            c_out, c_in, k, k)
    if ptr != weights.size:
        raise ValueError(f"trailing weights: consumed {ptr} of {weights.size}")
    return sd, header


def save_darknet_weights(layer_defs: Sequence[LayerDef],
                         state_dict: Dict[str, object], path: str,
                         header: Optional[np.ndarray] = None) -> None:
    """Inverse of `load_darknet_weights` (tensors or arrays accepted)."""
    def arr(key):
        v = state_dict[key]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        return np.asarray(v, np.float32)

    buf = io.BytesIO()
    buf.write(np.asarray(header if header is not None else [0, 0, 0, 0, 0],
                         np.int32).tobytes())
    for i, ld in enumerate(layer_defs):
        if ld.type not in ("convolutional", "yoloconvolutional"):
            continue
        if ld.batch_normalize:
            for attr in ("bias", "weight", "running_mean", "running_var"):
                buf.write(arr(f"{_bn_key(i)}.{attr}").tobytes())
        else:
            buf.write(arr(f"{_conv_key(i)}.bias").tobytes())
        buf.write(np.ascontiguousarray(arr(f"{_conv_key(i)}.weight")).tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def random_darknet_weights_file(layer_defs: Sequence[LayerDef], path: str,
                                seed: int = 0, scale: float = 0.05) -> None:
    """Write a synthetic `.weights` blob (byte-identical to the JAX
    package's for the same defs, seed and scale)."""
    rng = np.random.RandomState(seed)
    buf = io.BytesIO()
    buf.write(np.asarray([0, 2, 0, 0, 0], np.int32).tobytes())
    for ld in layer_defs:
        if ld.type not in ("convolutional", "yoloconvolutional"):
            continue
        c_out, c_in, k = ld.out_filters, ld.in_filters, ld.size
        if ld.batch_normalize:
            buf.write((rng.randn(c_out) * scale).astype(np.float32).tobytes())      # beta
            buf.write((1 + rng.randn(c_out) * scale).astype(np.float32).tobytes())  # gamma
            buf.write((rng.randn(c_out) * scale).astype(np.float32).tobytes())      # mean
            buf.write(np.abs(1 + rng.randn(c_out) * scale).astype(np.float32).tobytes())  # var
        else:
            buf.write((rng.randn(c_out) * scale).astype(np.float32).tobytes())
        buf.write((rng.randn(c_out * c_in * k * k) * scale).astype(np.float32).tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())
