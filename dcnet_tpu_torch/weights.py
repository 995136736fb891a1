"""Weights for the port: the JAX-checkpoint bridge, the committed lock
`.npz` files, strict loading, seeded random init and Darknet backbone
splicing.

`state_dict_from_jax` is the port's own numpy-only copy of the key map and
layout transposes of `dcnet_tpu/train/checkpoint.py` (export direction):
it turns the JAX package's numpy `params` / `batch_stats` trees into the
reference state_dict the port's modules are named after; the BERT body
goes to the HuggingFace names under `textmodel.` (the inverse of
`dcnet_tpu/models/bert.py::convert_hf_bert_params`), its `proj` to
`textmodel.proj`.

    flax -> torch layouts: Dense kernel (I, O) -> Linear weight (O, I);
    Conv kernel HWIO -> (O, I, kH, kW); Conv1d kernel (k, I, O) -> (O, I, k);
    LSTM w_{ih,hh} (D, 4H) -> weight_{ih,hh}_l0 (4H, D).
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dcnet_tpu_torch.models.darknet import load_darknet_weights


def _lin(v: np.ndarray) -> np.ndarray:
    return v.transpose(1, 0)


def _conv2d(v: np.ndarray) -> np.ndarray:
    return v.transpose(3, 2, 0, 1)


def _conv1d(v: np.ndarray) -> np.ndarray:
    return v.transpose(2, 1, 0)


Spec = Tuple[str, Tuple[str, ...], Optional[Callable[[np.ndarray], np.ndarray]]]


def conv_bn_relu_paths(light: bool) -> Dict[str, Tuple[str, ...]]:
    """The trunk's ConvBNReLUs: the port's module name -> its path in the
    JAX trees (mapping_visu, corr_conv, the fusion FCNs' emb / out stacks)."""
    table: Dict[str, Tuple[str, ...]] = {}
    for s in range(3):
        table[f"mapping_visu.{s}"] = (f"mapping_visu_{s}",)
        table[f"corr_conv.{s}.0"] = (f"corr_conv_{s}",)
    for s in range(3):
        fcn = f"fcn_{s}"
        for j in range(1 if light else 3):
            table[f"fcn_emb.{s}.{j}"] = (fcn, f"emb{j}")
        if not light:
            table[f"fcn_out.{s}.0"] = (fcn, "out0")
    return table


def trunk_scale_keys(light: bool = False) -> Dict[str, str]:
    """The port's int8 trunk convs -> the keys of their calibrated input
    abs-max in the JAX package's 'quant' collection, flattened with '/' as
    `dcnet_tpu.ops.quant.save_trunk_scales` writes them
    ("mapping_visu_0/conv/act_max", "fcn_1/emb2/conv/act_max", ...)."""
    return {name: "/".join(path + ("conv", "act_max"))
            for name, path in conv_bn_relu_paths(light).items()}


def _key_map(params: Mapping[str, Any], light: bool) -> Dict[str, Spec]:
    """reference key -> ('params' | 'stats', path in the JAX tree, layout fn)."""
    table: Dict[str, Spec] = {}

    def bn(torch_prefix, path):
        for attr, (kind, leaf) in (("weight", ("params", "scale")),
                                   ("bias", ("params", "bias")),
                                   ("running_mean", ("stats", "mean")),
                                   ("running_var", ("stats", "var"))):
            table[f"{torch_prefix}.{attr}"] = (kind, path + (leaf,), None)

    def cbr(torch_prefix, path):  # ConvBNReLU: <prefix>.conv + <prefix>.bn
        table[f"{torch_prefix}.conv.weight"] = (
            "params", path + ("conv", "kernel"), _conv2d)
        bn(f"{torch_prefix}.bn", path + ("bn",))

    def dense_bn(torch_lin, torch_bn, path):
        table[f"{torch_lin}.weight"] = ("params", path + ("fc", "kernel"), _lin)
        table[f"{torch_lin}.bias"] = ("params", path + ("fc", "bias"), None)
        bn(torch_bn, path + ("bn",))

    # backbone: visumodel.module_list.{i}.{conv,batch_norm}_{i}.*
    for name, leaves in params.get("visumodel", {}).items():
        kind, i = name.split("_")
        if kind == "conv":
            prefix = f"visumodel.module_list.{i}.conv_{i}"
            table[f"{prefix}.weight"] = (
                "params", ("visumodel", name, "kernel"), _conv2d)
            if "bias" in leaves:
                table[f"{prefix}.bias"] = (
                    "params", ("visumodel", name, "bias"), None)
        elif kind == "bn":
            bn(f"visumodel.module_list.{i}.batch_norm_{i}", ("visumodel", name))

    # BiLSTM language encoder
    table["textmodel.embedding.weight"] = (
        "params", ("textmodel", "embedding", "embedding"), None)
    table["textmodel.mlp.0.weight"] = ("params", ("textmodel", "mlp", "kernel"), _lin)
    table["textmodel.mlp.0.bias"] = ("params", ("textmodel", "mlp", "bias"), None)
    for tdir, ours in (("", "fwd"), ("_reverse", "bwd")):
        for gate in ("ih", "hh"):
            table[f"textmodel.rnn.weight_{gate}_l0{tdir}"] = (
                "params", ("textmodel", f"{ours}_w_{gate}"), _lin)
            table[f"textmodel.rnn.bias_{gate}_l0{tdir}"] = (
                "params", ("textmodel", f"{ours}_b_{gate}"), None)

    # frozen BERT body (HF names under textmodel.) and its trained proj
    bert = params.get("textmodel", {}).get("bert", {})
    if "proj" in params.get("textmodel", {}):
        table["textmodel.proj.weight"] = ("params", ("textmodel", "proj", "kernel"), _lin)
        table["textmodel.proj.bias"] = ("params", ("textmodel", "proj", "bias"), None)
    if bert:
        for k, leaf in bert_key_map(bert).items():
            kind, path, fn = leaf
            table["textmodel." + k] = (kind, ("textmodel", "bert") + path, fn)

    # attention and location heads
    for name in ("sub_attn", "loc_attn"):
        table[f"{name}.fc.weight"] = ("params", (name, "fc", "kernel"), _lin)
        table[f"{name}.fc.bias"] = ("params", (name, "fc", "bias"), None)
    dense_bn("loc_embedding.0", "loc_embedding.1", ("loc_embedding",))
    dense_bn("loc_text_embedding.0", "loc_text_embedding.1",
             ("loc_text_embedding",))

    # mapping modules, corr_conv and the fusion FCNs' ConvBNReLUs
    for name, path in conv_bn_relu_paths(light).items():
        cbr(name, path)
    dense_bn("mapping_lang.0", "mapping_lang.1", ("mapping_lang", "l0"))
    dense_bn("mapping_lang.4", "mapping_lang.5", ("mapping_lang", "l1"))

    # cross-modal Conv1d smoothing (training path)
    table["feature_map.0.weight"] = ("params", ("feature_map", "kernel"), _conv1d)
    table["feature_map.0.bias"] = ("params", ("feature_map", "bias"), None)

    # box head (the plain 1x1 conv after the fusion FCN)
    for s in range(3):
        fcn = f"fcn_{s}"
        plain_out = f"fcn_out.{s}.0" if light else f"fcn_out.{s}.1"
        table[f"{plain_out}.weight"] = ("params", (fcn, "out1", "kernel"), _conv2d)
        table[f"{plain_out}.bias"] = ("params", (fcn, "out1", "bias"), None)
    return table


def bert_key_map(bert: Mapping[str, Any]) -> Dict[str, Spec]:
    """HF BertModel key -> ('params', path in the JAX BertModel tree,
    layout fn), for the layers `bert` holds: the inverse of the JAX
    package's `convert_hf_bert_params`."""
    table: Dict[str, Spec] = {}

    def lin(key, path):
        table[f"{key}.weight"] = ("params", path + ("kernel",), _lin)
        table[f"{key}.bias"] = ("params", path + ("bias",), None)

    def ln(key, path):
        table[f"{key}.weight"] = ("params", path + ("scale",), None)
        table[f"{key}.bias"] = ("params", path + ("bias",), None)

    for name in ("word", "position", "token_type"):
        table[f"embeddings.{name}_embeddings.weight"] = (
            "params", (f"{name}_embeddings", "embedding"), None)
    ln("embeddings.LayerNorm", ("embeddings_layernorm",))
    n_layers = sum(1 for k in bert if re.fullmatch(r"layer_\d+", k))
    for i in range(n_layers):
        p, j = f"encoder.layer.{i}", (f"layer_{i}",)
        for qkv in ("query", "key", "value"):
            lin(f"{p}.attention.self.{qkv}", j + ("attention_self", qkv))
        lin(f"{p}.attention.output.dense", j + ("attention_output",))
        ln(f"{p}.attention.output.LayerNorm", j + ("attention_layernorm",))
        lin(f"{p}.intermediate.dense", j + ("intermediate",))
        lin(f"{p}.output.dense", j + ("output",))
        ln(f"{p}.output.LayerNorm", j + ("output_layernorm",))
    return table


def state_dict_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                        light: bool = False) -> Dict[str, np.ndarray]:
    """The JAX package's (numpy) `params` and `batch_stats` trees -> the
    port's state_dict as float arrays in the reference namespace. Modules
    absent from the trees are left out; num_batches_tracked is not part of
    it (`load_into` fills it)."""
    out: Dict[str, np.ndarray] = {}
    for key, (kind, path, fn) in _key_map(params, light).items():
        node: Any = params if kind == "params" else batch_stats
        try:
            for p in path:
                node = node[p]
        except KeyError:
            continue
        v = np.asarray(node)
        out[key] = np.ascontiguousarray(fn(v) if fn else v)
    return out


def load_into(model: nn.Module, state_dict: Mapping[str, Any]):
    """Load a reference-namespace state_dict (numpy arrays or tensors; an
    optional DDP `module.` prefix is dropped) into a port module, strictly.
    BatchNorm `num_batches_tracked` counters the dict lacks keep the
    module's own value."""
    sd: Dict[str, torch.Tensor] = {}
    for k, v in state_dict.items():
        k = re.sub(r"^module\.", "", k)
        sd[k] = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))  # a writable copy
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, v)
    return model.load_state_dict(sd, strict=True)


@torch.no_grad()
def seeded_init_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from one seeded CPU torch.Generator (the same numbers
    on any device): fan-in-scaled normal kernels, small biases, BN affine
    near identity with running statistics near (0, 1), the LSTM's uniform
    +-1/sqrt(H)."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def put(t: torch.Tensor, v: torch.Tensor) -> None:
        t.copy_(v.to(t.dtype))

    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            put(m.weight, torch.randn(m.weight.shape, generator=g) / math.sqrt(fan_in))
            if m.bias is not None:
                put(m.bias, 0.01 * torch.randn(m.bias.shape, generator=g))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            n = m.num_features
            put(m.weight, 1 + 0.1 * torch.randn(n, generator=g))
            put(m.bias, 0.1 * torch.randn(n, generator=g))
            put(m.running_mean, 0.1 * torch.randn(n, generator=g))
            put(m.running_var, 0.5 + torch.rand(n, generator=g))
        elif isinstance(m, nn.Embedding):
            put(m.weight, torch.randn(m.weight.shape, generator=g))
        elif isinstance(m, nn.LayerNorm):
            put(m.weight, 1 + 0.1 * torch.randn(m.weight.shape, generator=g))
            put(m.bias, 0.1 * torch.randn(m.bias.shape, generator=g))
        elif isinstance(m, nn.LSTM):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                put(p, (2 * torch.rand(p.shape, generator=g) - 1) * bound)
    return model


def splice_darknet_weights(model: nn.Module, path: str) -> None:
    """Load a Darknet `.weights` file into `model.visumodel` (the rest of
    the model keeps its weights)."""
    sd, _ = load_darknet_weights(model.visumodel.layer_defs, path)
    full = dict(model.state_dict())
    for k, v in sd.items():
        if k not in full:
            raise KeyError(f"{k} from {path} is not a parameter of the model")
        full[k] = v
    load_into(model, full)


def read_lock_npz(path: str) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """A lock `.npz` (the layout `tools/lock_pack.py` packs: '/'-joined
    `params/...` and `bstats/...` keys in float16, JSON `__meta__`) ->
    (params, batch_stats, meta), the trees nested and in float32, read with
    numpy alone."""
    z = np.load(path)
    meta = json.loads(str(z["__meta__"])) if "__meta__" in z.files else {}
    if meta.get("bert"):
        raise NotImplementedError(
            f"{path} is a BERT lock: it leaves out the frozen BERT body, which "
            "the JAX package regenerates from flax's seed-13 init (checked "
            "against __meta__['frozen_fingerprint']) and the port cannot "
            "regenerate without JAX. Restore it with the JAX package "
            "(tools/lock_pack.py unpack), then carry the trees across with "
            "dcnet_tpu_torch.weights.state_dict_from_jax")
    trees: Dict[str, Dict[str, Any]] = {"params": {}, "bstats": {}}
    for key in z.files:
        kind, _, rest = key.partition("/")
        if kind not in trees:
            continue
        node, parts = trees[kind], rest.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key].astype(np.float32)
    return trees["params"], trees["bstats"], meta


def load_lock_into(model: nn.Module, path: str, light: bool = False):
    """Load a lock `.npz` into a port model, strictly."""
    params, batch_stats, _ = read_lock_npz(path)
    return load_into(model, state_dict_from_jax(params, batch_stats, light=light))
