"""Post-training int8 quantization of the backbone and the trunk.

The port of `dcnet_tpu/ops/quant.py`, NHWC, with the same static-scale
design: weights symmetric per output channel (s_w = max|w| / 127),
activations symmetric per tensor with scales calibrated once (s_in =
abs-max / 127), eval BatchNorm folded into each conv's per-channel output
scale and bias, the routing (shortcut add, route concat, upsample) in the
activation dtype between the quantized convs. Every int8 convolution runs
through kernel K6 (`kernels.conv_s8.conv_s8`), whose epilogue applies the
scale and bias as one fused multiply-add, as XLA's CPU backend does for
the JAX package. The quantized parameters keep the JAX package's `.npz`
formats (`save_qparams` / `load_qparams`, `save_trunk_scales` /
`load_trunk_scales`), so either package reads the other's files.

The port's qparams: {str(i): {"w": int8 (Co, k, k, Ci) (K6's layout),
"inv_in": 1 / s_in (a Python float holding an fp32 value), "scale":
s_in s_w a (Co,) fp32, "bias": (Co,) fp32}} on the model's device.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dcnet_tpu_torch.kernels.conv_s8 import conv_s8
from dcnet_tpu_torch.models.darknet import LayerDef, _max_pool_nhwc, upsample2
from dcnet_tpu_torch.models.heads import conv_nhwc, leaky_relu
from dcnet_tpu_torch.utils.profiling import on_device, trace_annotation
from dcnet_tpu_torch.weights import trunk_scale_keys

_EPS = 1e-5  # backbone BN epsilon
_CONV = ("convolutional", "yoloconvolutional")

ConvFn = Callable[[int, LayerDef, torch.Tensor], torch.Tensor]


def conv_layer_ids(layer_defs: Sequence[LayerDef]) -> List[int]:
    return [i for i, ld in enumerate(layer_defs) if ld.type in _CONV]


def _inputs(i: int, ld: LayerDef) -> List[int]:
    """The layers whose outputs layer i reads (-1: the image)."""
    if ld.type == "route":
        return [s if s >= 0 else i + s for s in ld.layers]
    if ld.type == "shortcut":
        return [i - 1, ld.from_ if ld.from_ >= 0 else i + ld.from_]
    return [i - 1]


def live_layers(layer_defs: Sequence[LayerDef]) -> set:
    """The layers whose outputs reach a captured map: the inputs of the
    `yoloconvolutional` convs and everything they depend on. Under jit XLA
    drops the rest (the detection convs after each capture); eager PyTorch
    would compute them."""
    need = {j - 1 for j, ld in enumerate(layer_defs) if ld.type == "yoloconvolutional"}
    for i in range(len(layer_defs) - 1, -1, -1):
        if i in need:
            need.update(_inputs(i, layer_defs[i]))
    return need


def traverse(layer_defs: Sequence[LayerDef], x: torch.Tensor, conv_fn: ConvFn,
             prune: bool = True) -> List[torch.Tensor]:
    """DarknetBackbone's routing with a pluggable conv executor: the three
    captured maps (coarsest first). `prune` skips the layers no capture
    needs (`live_layers`); calibration taps every conv and runs them all."""
    live = live_layers(layer_defs) if prune else None
    captured: List[torch.Tensor] = []
    outs: List[Optional[torch.Tensor]] = []
    for i, ld in enumerate(layer_defs):
        if live is not None and i not in live:
            if ld.type == "yoloconvolutional":
                captured.append(x)
            outs.append(None)
            continue
        if ld.type in _CONV:
            if ld.type == "yoloconvolutional":
                captured.append(x)
            x = conv_fn(i, ld, x)
        elif ld.type == "maxpool":
            x = _max_pool_nhwc(x, ld.size, ld.stride)
        elif ld.type == "upsample":
            x = upsample2(x)
        elif ld.type == "route":
            x = torch.cat([outs[s] for s in _inputs(i, ld)], dim=-1)
        elif ld.type == "shortcut":
            x = x + outs[_inputs(i, ld)[1]]
        outs.append(x)
    return captured


def _fold_bn(backbone, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) fp32 with bn_eval(y) == y * a + b: a = gamma / sqrt(var +
    eps), b = beta - mean * a. JAX takes lax.rsqrt, which XLA's CPU backend
    rounds faithfully (within one unit in the last place); the port rounds
    1 / sqrt once from float64, so a may sit one unit off JAX's."""
    bn = backbone.module_list[i][1]
    var = bn.running_var.float() + _EPS
    a = bn.weight.float() * (1.0 / var.double().sqrt()).float()
    return a, bn.bias.float() - bn.running_mean.float() * a


def fp_conv_fn(backbone) -> ConvFn:
    """Float executor: conv + folded eval BN + leaky, in x's dtype (the
    calibration reference; DarknetBackbone's eval within BN reassociation)."""
    def fn(i: int, ld: LayerDef, x: torch.Tensor) -> torch.Tensor:
        conv = backbone.module_list[i][0]
        y = conv_nhwc(x, conv.weight, None, ld.stride, ld.pad)
        if ld.batch_normalize:
            a, b = _fold_bn(backbone, i)
            y = y * a.to(y.dtype) + b.to(y.dtype)
        else:
            y = y + conv.bias.to(y.dtype)
        return leaky_relu(y) if ld.activation == "leaky" else y
    return fn


@torch.no_grad()
def calibrate(layer_defs: Sequence[LayerDef], backbone,
              images: torch.Tensor) -> Dict[str, float]:
    """Per-conv input abs-max over a calibration batch (float pass); merge
    several batches with `merge_calibration`."""
    fp = fp_conv_fn(backbone)
    maxes: Dict[str, torch.Tensor] = {}

    def tap(i: int, ld: LayerDef, x: torch.Tensor) -> torch.Tensor:
        maxes[str(i)] = x.abs().amax()
        return fp(i, ld, x)

    traverse(layer_defs, images.float(), tap, prune=False)
    return {k: float(v) for k, v in maxes.items()}


def merge_calibration(batches: Sequence[Dict[str, Any]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for m in batches:
        for k, v in m.items():
            out[k] = max(out.get(k, 0.0), float(v))
    return out


@torch.no_grad()
def quantize_backbone(layer_defs: Sequence[LayerDef], backbone,
                      act_max: Dict[str, float]) -> Dict:
    """The int8 parameters from the float backbone and its calibration, in
    numpy with the JAX package's fp32 / float64 steps: s_w = max(max|w|,
    1e-12) / 127 (fp32), w = clip(round(w / s_w)), s_in = max(act_max,
    1e-12) / 127 (float64), inv_in = fp32(1 / s_in), scale = fp32(s_in) s_w
    a, bias b (fp32). Parameters stored in bf16 quantize the same way."""
    dev = backbone.module_list[conv_layer_ids(layer_defs)[0]][0].weight.device
    q: Dict[str, Dict[str, Any]] = {}
    for i in conv_layer_ids(layer_defs):
        ld = layer_defs[i]
        conv = backbone.module_list[i][0]
        w = conv.weight.detach().float().cpu().numpy()            # (O, I, k, k)
        s_w = np.maximum(np.abs(w).max(axis=(1, 2, 3)), np.float32(1e-12)) \
            / np.float32(127.0)
        wq = np.clip(np.round(w / s_w[:, None, None, None]), -127, 127).astype(np.int8)
        s_in = max(act_max[str(i)], 1e-12) / 127.0
        if ld.batch_normalize:
            a, b = (t.cpu().numpy() for t in _fold_bn(backbone, i))
        else:
            a = np.ones(w.shape[0], np.float32)
            b = conv.bias.detach().float().cpu().numpy()
        q[str(i)] = {
            "w": torch.from_numpy(wq.transpose(0, 2, 3, 1).copy()).to(dev),
            "inv_in": float(np.float32(1.0 / s_in)),
            "scale": torch.from_numpy(np.float32(s_in) * s_w * a).to(dev),
            "bias": torch.from_numpy(np.asarray(b, np.float32)).to(dev),
        }
    return q


def sole_conv_consumer(layer_defs: Sequence[LayerDef]) -> Dict[int, int]:
    """{producer conv i -> consumer conv j} for convs whose output feeds
    exactly one other conv and nothing else: those activations can leave
    the producer already quantized with the consumer's input scale (the
    int8 chain). Consumers as `traverse` reads them: layer m+1 reads layer
    m (route reads only its listed layers), shortcut also reads `from_`,
    and a yoloconvolutional's input is also captured."""
    n = len(layer_defs)
    consumers: Dict[int, List] = {i: [] for i in range(-1, n)}
    for m, ld in enumerate(layer_defs):
        if ld.type == "route":
            for s in ld.layers:
                consumers[s if s >= 0 else m + s].append(("any", m))
        else:
            kind = "conv" if ld.type in _CONV else "any"
            consumers[m - 1].append((kind, m))
            if ld.type == "yoloconvolutional":
                consumers[m - 1].append(("capture", m))
            if ld.type == "shortcut":
                f = ld.from_ if ld.from_ >= 0 else m + ld.from_
                consumers[f].append(("any", m))
    out: Dict[int, int] = {}
    for i, ld in enumerate(layer_defs):
        if ld.type not in _CONV:
            continue
        cons = consumers[i]
        if len(cons) == 1 and cons[0][0] == "conv":
            out[i] = cons[0][1]
    return out


def int8_conv_fn(qparams: Dict, act_dtype: torch.dtype = torch.float32,
                 out_quant: Optional[Dict[int, int]] = None) -> ConvFn:
    """Int8 executor: K6 quantizes a float input with this conv's static
    scale as it gathers it, clamp(round(x * inv_in)) in fp32 (an int8
    input already carries that scale), and its epilogue applies fma(acc,
    scale, bias) [+ leaky], stored in `act_dtype` (the routing traffic
    between convs), or, for the producers of `out_quant`
    (`sole_conv_consumer`), requantized with the consumer's scale and
    stored as int8."""
    out_quant = out_quant or {}

    def fn(i: int, ld: LayerDef, x: torch.Tensor) -> torch.Tensor:
        qp = qparams[str(i)]
        j = out_quant.get(i)
        epi = dict(scale=qp["scale"], bias=qp["bias"],
                   act="leaky" if ld.activation == "leaky" else None,
                   in_inv=None if x.dtype == torch.int8 else qp["inv_in"])
        if j is not None:
            epi.update(out_dtype=torch.int8, inv_out=qparams[str(j)]["inv_in"])
        else:
            epi.update(out_dtype=act_dtype)
        return conv_s8(x.contiguous(), qp["w"], ld.stride, ld.pad, **epi)
    return fn


@torch.no_grad()
def backbone_apply_fp(layer_defs: Sequence[LayerDef], backbone,
                      images: torch.Tensor) -> List[torch.Tensor]:
    """Float traversal (DarknetBackbone's eval semantics, folded BN)."""
    return traverse(layer_defs, images.float(), fp_conv_fn(backbone))


@torch.no_grad()
def backbone_apply_int8(layer_defs: Sequence[LayerDef], qparams: Dict,
                        images: torch.Tensor, act_dtype: torch.dtype = torch.float32,
                        int8_chain: bool = False) -> List[torch.Tensor]:
    """Quantized traversal: the three captured maps in `act_dtype`.
    `int8_chain` stores sole-consumer activations as int8
    (`sole_conv_consumer`); the JAX package's offline eval bench opts in."""
    oq = sole_conv_consumer(layer_defs) if int8_chain else None
    return traverse(layer_defs, images, int8_conv_fn(qparams, act_dtype, out_quant=oq))


# --------------------------------------------------------------------------
# Model-level conveniences
# --------------------------------------------------------------------------

def model_layer_defs(model) -> Tuple[LayerDef, ...]:
    return model.visumodel.layer_defs


@torch.no_grad()
def quantize_model_backbone(model, calib_images, calib_batch: int = 8) -> Dict:
    """Calibrate and quantize a DCNet's backbone on `calib_images` (N, H, W,
    3) normalized fp32 images, `calib_batch` at a time."""
    defs = model_layer_defs(model)
    images = torch.as_tensor(calib_images, device=model.device)
    batches = [calibrate(defs, model.visumodel, images[s:s + calib_batch])
               for s in range(0, images.shape[0], calib_batch)]
    return quantize_backbone(defs, model.visumodel, merge_calibration(batches))


@torch.no_grad()
@trace_annotation("dcnet.extract")
def quant_extract_features(model, qparams: Dict, images,
                           int8_chain: bool = False) -> List[torch.Tensor]:
    """`DCNet.extract_features` with the int8 backbone: the quantized conv
    stack (activations in the model's compute dtype, or int8 on
    sole-consumer chains) and the model's mapping head (float, or int8
    with cfg.trunk_quant)."""
    images = on_device(images, model.device)
    raw = backbone_apply_int8(model_layer_defs(model), qparams, images,
                              act_dtype=model.dtype, int8_chain=int8_chain)
    return model.map_features(raw)


# --------------------------------------------------------------------------
# Trunk quantization: mapping_visu, corr_conv and the fusion FCNs'
# ConvBNReLUs (models/heads.py), through the model itself
# --------------------------------------------------------------------------

def _trunk_convs(model) -> Dict[str, torch.nn.Module]:
    """The trunk's ConvBNReLUs by their JAX 'quant' collection key."""
    mods = dict(model.named_modules())
    return {key: mods[name] for name, key in trunk_scale_keys(model.cfg.light).items()}


def trunk_quant_variant(model, mode: str):
    """Switch the trunk convs to `mode` (off | calib | int8) in place and
    return the model: the JAX package builds a second module sharing the
    params; PyTorch modules carry their mode (cfg.trunk_quant follows)."""
    model.cfg = model.cfg.replace(trunk_quant=mode)
    for m in _trunk_convs(model).values():
        m.quant = mode
    return model


def trunk_scales(model) -> Dict[str, np.ndarray]:
    """The trunk convs' calibrated input abs-max, by the JAX package's keys."""
    return {k: m.act_max.detach().cpu().numpy().astype(np.float32)
            for k, m in _trunk_convs(model).items()}


def trunk_sources(model) -> Tuple[torch.Tensor, ...]:
    """What the trunk convs' cached int8 constants are made from
    (`ConvBNReLU.int8_sources`), every conv's in turn."""
    return tuple(t for m in _trunk_convs(model).values() for t in m.int8_sources())


@torch.no_grad()
def set_trunk_scales(model, scales: Dict[str, Any]):
    """Load `trunk_scales` (or the JAX package's flattened 'quant'
    collection) into the trunk convs. Returns the model."""
    convs = _trunk_convs(model)
    if set(scales) != set(convs):
        raise KeyError(f"trunk scales {sorted(set(scales) ^ set(convs))} do not "
                       f"match the model's trunk convs")
    for k, m in convs.items():
        m.act_max.copy_(torch.as_tensor(np.asarray(scales[k], np.float32)))
    return model


@torch.no_grad()
def calibrate_trunk(model, apply_fn: Callable) -> Dict[str, np.ndarray]:
    """Run `apply_fn(model)` with the trunk convs in calib mode, from zero,
    and return their input abs-max (`trunk_scales`); the model goes back to
    its mode. `apply_fn` runs the eval path that will run quantized."""
    mode = model.cfg.trunk_quant
    for m in _trunk_convs(model).values():
        m.act_max.zero_()
    trunk_quant_variant(model, "calib")
    try:
        apply_fn(model)
    finally:
        trunk_quant_variant(model, mode)
    return trunk_scales(model)


def save_trunk_scales(path: str, scales: Dict[str, Any]) -> None:
    """One .npz of the trunk scales, keyed as the JAX package keys them."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in scales.items()})


def load_trunk_scales(path: str) -> Dict[str, np.ndarray]:
    data = np.load(path)
    return {k: np.asarray(data[k]) for k in data.files}


# --------------------------------------------------------------------------
# The quantized backbone's file (the JAX package's deployment format)
# --------------------------------------------------------------------------

def save_qparams(path: str, qparams: Dict) -> None:
    """The quantized backbone as one .npz in the JAX package's layout:
    "{i}/w" int8 HWIO, "{i}/inv_in" fp32, "{i}/scale" and "{i}/bias" fp32."""
    flat = {}
    for i, d in qparams.items():
        flat[f"{i}/w"] = d["w"].cpu().numpy().transpose(1, 2, 3, 0)
        flat[f"{i}/inv_in"] = np.float32(d["inv_in"])
        flat[f"{i}/scale"] = d["scale"].cpu().numpy()
        flat[f"{i}/bias"] = d["bias"].cpu().numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_qparams(path: str, device=None) -> Dict:
    """A qparams .npz written by either package, repacked to K6's layout
    ((Co, k, k, Ci) int8) on `device` (the CPU by default)."""
    data = np.load(path)
    raw: Dict[str, Dict[str, np.ndarray]] = {}
    for key in data.files:
        i, k = key.split("/", 1)
        raw.setdefault(i, {})[k] = data[key]
    dev = torch.device("cpu") if device is None else torch.device(device)
    return {i: {"w": torch.from_numpy(np.ascontiguousarray(
                    d["w"].transpose(3, 0, 1, 2))).to(dev),
                "inv_in": float(np.float32(d["inv_in"])),
                "scale": torch.from_numpy(np.asarray(d["scale"], np.float32)).to(dev),
                "bias": torch.from_numpy(np.asarray(d["bias"], np.float32)).to(dev)}
            for i, d in raw.items()}


def conv_shapes(layer_defs: Sequence[LayerDef], size: int
                ) -> List[Tuple[int, int, int, int, int, int, int]]:
    """Each conv layer's (layer, k, stride, pad, Ci, Co, input side) on
    size x size images, in layer order."""
    sides: List[int] = []
    side, out = size, []
    for i, ld in enumerate(layer_defs):
        if ld.type in _CONV:
            out.append((i, ld.size, ld.stride, ld.pad, ld.in_filters, ld.filters, side))
            side = (side + 2 * ld.pad - ld.size) // ld.stride + 1
        elif ld.type == "upsample":
            side *= 2
        elif ld.type == "maxpool":
            side = -(-side // ld.stride)
        elif ld.type == "route":
            side = sides[_inputs(i, ld)[0]]
        sides.append(side)
    return out


@torch.no_grad()
def quant_eval_clip(model, qparams: Dict, images, word_ids, n_frame: int = 5,
                    int8_chain: bool = False):
    """`DCNet.eval_clip` on the int8 backbone, as the JAX package's eval
    bench composes it: `quant_extract_features`, then `eval_features` on
    the (B, n_frame, ...) feature stacks. images (B n_frame, H, W, 3)
    normalized; word_ids (B, L), the center frames' phrases."""
    feats = quant_extract_features(model, qparams, images, int8_chain=int8_chain)
    b = feats[0].shape[0] // n_frame
    return model.eval_features([f.reshape(b, n_frame, *f.shape[1:]) for f in feats],
                               torch.as_tensor(word_ids, device=model.device))
