"""The plain reference of DCNet: the grounding model written out in plain
PyTorch operations over a dict of weights, with no kernel, no cache and no
batching trick of the program. It imports nothing of the program, and of
JAX nothing.

It follows the published model (github.com/mengcaopku/DCNet): the YOLOv3
backbone, whose three captured maps are mapped to the joint width and
l2-normalised; the center frame co-attending to each reference frame
(softmax of T q kᵀ, T the co-attention temperature), concatenated with
its own features and reduced by `corr_conv`, l2-normalised and averaged
over the references; the fusion trunk on [features, phrase, coordinates];
the subject and location attention that modulate the confidence (the
location term through the coordinate Gram matrix, formed whole here); the
argmax and top-k decode; the serving engine's temporal fusion; and for
training the k=2 forward with its contrastive samples, the five losses and
RMSprop.

`Prec` is the precision the reference computes in: "fp32" (with TF32 off,
set by the caller) is the reference; "fp8" and "int4" round the operands
of every convolution, linear layer and attention product to that format
(per-tensor scales for activations, per-output-channel for weights), the
controls of the bf16 and int8 cells.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.geometry import CONV_TYPES, Geometry, sources

Weights = Dict[str, torch.Tensor]

FP8_MAX = 448.0      # float8_e4m3fn's largest finite value


class Prec:
    """Rounding of the operands of each product."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "tf32", "fp8", "int4"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def _round(self, x: torch.Tensor, dims) -> torch.Tensor:
        if self.mode in ("fp32", "tf32"):
            return x
        amax = x.abs().amax(dim=dims, keepdim=True) if dims else x.abs().amax()
        if self.mode == "fp8":
            s = torch.clamp(amax, min=1e-30) / FP8_MAX
            return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s
        s = torch.clamp(amax, min=1e-30) / 7.0
        return torch.clamp(torch.round(x / s), -7, 7) * s

    def a(self, x: torch.Tensor) -> torch.Tensor:
        """An activation entering a product: one scale for the tensor."""
        return self._round(x, None)

    def w(self, w: torch.Tensor) -> torch.Tensor:
        """A weight: one scale per output channel (dim 0)."""
        return self._round(w, tuple(range(1, w.dim())))


FP32 = Prec("fp32")


# ---------------------------------------------------------------------------
# the parameter list
# ---------------------------------------------------------------------------

class Param(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    kind: str     # how the benchmark draws it: see portbench.weights


def _bn(out: List[Param], prefix: str, n: int, bias: str = "bn_bias") -> None:
    out += [Param(f"{prefix}.weight", (n,), "bn_weight"),
            Param(f"{prefix}.bias", (n,), bias),
            Param(f"{prefix}.running_mean", (n,), "bn_mean"),
            Param(f"{prefix}.running_var", (n,), "bn_var"),
            Param(f"{prefix}.num_batches_tracked", (), "count")]


def _linear(out: List[Param], prefix: str, o: int, i: int, bias: bool = True,
            kind: str = "fan_in") -> None:
    out.append(Param(f"{prefix}.weight", (o, i), kind))
    if bias:
        out.append(Param(f"{prefix}.bias", (o,), "bias"))


def _cbr(out: List[Param], prefix: str, o: int, i: int, k: int) -> None:
    out.append(Param(f"{prefix}.conv.weight", (o, i, k, k), "fan_in"))
    _bn(out, f"{prefix}.bn", o)


def param_spec(g: Geometry) -> List[Param]:
    """Every weight and buffer of the model, under the names of the
    published model's state_dict."""
    out: List[Param] = []
    layers = g.layers()
    for i, ly in enumerate(layers):
        if ly.type in CONV_TYPES:
            p = f"visumodel.module_list.{i}"
            out.append(Param(f"{p}.conv_{i}.weight", (ly.filters, ly.in_ch, ly.size, ly.size),
                             "fan_in"))
            if ly.bn:
                _bn(out, f"{p}.batch_norm_{i}", ly.filters)
            else:
                out.append(Param(f"{p}.conv_{i}.bias", (ly.filters,), "bias"))
    emb, td = g.emb_size, g.textdim
    if g.text_encoder == "bilstm":
        h, wv = g.lstm_hidden, td // 2
        out.append(Param("textmodel.embedding.weight", (g.corpus_size, g.word_embedding_size),
                         "embedding"))
        _linear(out, "textmodel.mlp.0", wv, g.word_embedding_size)
        for sfx in ("", "_reverse"):
            out += [Param(f"textmodel.rnn.weight_ih_l0{sfx}", (4 * h, wv), "lstm"),
                    Param(f"textmodel.rnn.weight_hh_l0{sfx}", (4 * h, h), "lstm"),
                    Param(f"textmodel.rnn.bias_ih_l0{sfx}", (4 * h,), "lstm"),
                    Param(f"textmodel.rnn.bias_hh_l0{sfx}", (4 * h,), "lstm")]
    else:
        b = g.bert
        e = "textmodel.embeddings"
        out += [Param(f"{e}.word_embeddings.weight", (b.vocab_size, b.hidden_size), "embedding"),
                Param(f"{e}.position_embeddings.weight", (b.max_position, b.hidden_size),
                      "embedding"),
                Param(f"{e}.token_type_embeddings.weight", (b.type_vocab_size, b.hidden_size),
                      "embedding"),
                Param(f"{e}.LayerNorm.weight", (b.hidden_size,), "ln_weight"),
                Param(f"{e}.LayerNorm.bias", (b.hidden_size,), "ln_bias")]
        hs = b.hidden_size
        for li in range(b.num_layers):
            p = f"textmodel.encoder.layer.{li}"
            for qkv in ("query", "key", "value"):
                _linear(out, f"{p}.attention.self.{qkv}", hs, hs)
            _linear(out, f"{p}.attention.output.dense", hs, hs)
            out += [Param(f"{p}.attention.output.LayerNorm.weight", (hs,), "ln_weight"),
                    Param(f"{p}.attention.output.LayerNorm.bias", (hs,), "ln_bias")]
            _linear(out, f"{p}.intermediate.dense", b.intermediate_size, hs)
            _linear(out, f"{p}.output.dense", hs, b.intermediate_size)
            out += [Param(f"{p}.output.LayerNorm.weight", (hs,), "ln_weight"),
                    Param(f"{p}.output.LayerNorm.bias", (hs,), "ln_bias")]
        _linear(out, "textmodel.proj", emb, hs)
    for name in ("sub_attn", "loc_attn"):
        _linear(out, f"{name}.fc", 1, td)
    _linear(out, "loc_embedding.0", 8, 8)
    _bn(out, "loc_embedding.1", 8)
    # its input rows are the coordinate Gram weighted by the l2-normalised
    # objectness map over all positions: unit norm, not unit entries
    _linear(out, "loc_text_embedding.0", emb, g.all_positions, kind="unit_in")
    # its ReLU rows are l2-normalised and dotted with a non-negative phrase
    # vector: dense rows would all lie near one angle to it, and the
    # min-max normalised map would be little but rounding; a negative
    # bias keeps them sparse
    _bn(out, "loc_text_embedding.1", emb, bias="bn_bias_sparse")
    captured = [ly.in_ch for ly in layers if ly.type == "yoloconvolutional"]
    for s, c in enumerate(captured):
        _cbr(out, f"mapping_visu.{s}", emb, c, 1)
    _linear(out, "mapping_lang.0", emb, td)
    _bn(out, "mapping_lang.1", emb)
    _linear(out, "mapping_lang.4", emb, emb)
    _bn(out, "mapping_lang.5", emb)
    for s in range(3):
        _cbr(out, f"corr_conv.{s}.0", emb, 2 * emb, 1)
    out.append(Param("feature_map.0.weight", (g.query_len, g.query_len, 3), "fan_in"))
    out.append(Param("feature_map.0.bias", (g.query_len,), "bias"))
    for s in range(3):
        _cbr(out, f"fcn_emb.{s}.0", emb, 2 * emb + 8, 1)
        _cbr(out, f"fcn_emb.{s}.1", emb, emb, 3)
        _cbr(out, f"fcn_emb.{s}.2", emb, emb, 1)
    for s in range(3):
        _cbr(out, f"fcn_out.{s}.0", emb // 2, emb, 1)
        out.append(Param(f"fcn_out.{s}.1.weight", (15, emb // 2, 1, 1), "fan_in"))
        out.append(Param(f"fcn_out.{s}.1.bias", (15,), "bias"))
    return out


def frozen(name: str) -> bool:
    """The BERT body is frozen: no gradient, no update."""
    return name.startswith("textmodel.") and not name.startswith("textmodel.proj") \
        and ("embeddings" in name or ".encoder." in name)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def l2n(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=1e-24))


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int, pad: int,
         P: Prec) -> torch.Tensor:
    """NCHW convolution."""
    return F.conv2d(P.a(x), P.w(w), b, stride, pad)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], P: Prec) -> torch.Tensor:
    return F.linear(P.a(x), P.w(w), b)


def bn(x: torch.Tensor, W: Weights, prefix: str, train: bool, ch_dim: int = 1) -> torch.Tensor:
    """BatchNorm over channel axis `ch_dim`: the running statistics, or in
    training the batch's mean and biased variance. eps 1e-5."""
    shape = [1] * x.dim()
    shape[ch_dim] = -1
    if train:
        dims = tuple(d for d in range(x.dim()) if d != ch_dim)
        var, mean = torch.var_mean(x, dim=dims, correction=0)
    else:
        mean, var = W[f"{prefix}.running_mean"], W[f"{prefix}.running_var"]
    inv = torch.rsqrt(var + 1e-5) * W[f"{prefix}.weight"]
    return (x - mean.reshape(shape)) * inv.reshape(shape) + W[f"{prefix}.bias"].reshape(shape)


def cbr(x: torch.Tensor, W: Weights, prefix: str, train: bool, P: Prec) -> torch.Tensor:
    """conv (no bias) -> BN -> ReLU, NCHW."""
    w = W[f"{prefix}.conv.weight"]
    y = conv(x, w, None, 1, (w.shape[-1] - 1) // 2, P)
    return F.relu(bn(y, W, f"{prefix}.bn", train))


def dropout(x: torch.Tensor, p: float, train: bool) -> torch.Tensor:
    return F.dropout(x, p, training=True) if train and p > 0 else x


def coord_map(h: int, w: int, device) -> torch.Tensor:
    """(8, h, w): each cell's box corners, center and size in [-1, 1]
    coordinates, as the published model's `generate_coord` lays them out."""
    rows = torch.arange(h, device=device, dtype=torch.float32)[:, None].expand(h, w)
    cols = torch.arange(w, device=device, dtype=torch.float32)[None, :].expand(h, w)
    r0, c0 = (rows * 2 - w) / w, (cols * 2 - h) / h
    r1, c1 = ((rows + 1) * 2 - w) / w, ((cols + 1) * 2 - h) / h
    return torch.stack([r0, c0, r1, c1, (r0 + r1) / 2, (c0 + c1) / 2,
                        torch.full_like(rows, 1.0 / h), torch.full_like(rows, 1.0 / w)])


# ---------------------------------------------------------------------------
# visual path
# ---------------------------------------------------------------------------

def backbone(W: Weights, g: Geometry, images: torch.Tensor, train: bool = False,
             P: Prec = FP32) -> List[torch.Tensor]:
    """images NHWC (N, H, W, 3) -> the three captured NCHW maps (coarsest
    first): the inputs of the `yoloconvolutional` convs."""
    layers = g.layers()
    need = set()
    for i, ly in enumerate(layers):
        need.update(s for s in sources(i, ly) if ly.type in ("route", "shortcut"))
    x = images.permute(0, 3, 1, 2).float()
    captured, saved = [], {}
    last_capture = max(i for i, ly in enumerate(layers) if ly.type == "yoloconvolutional")
    for i, ly in enumerate(layers):
        if ly.type in CONV_TYPES:
            if ly.type == "yoloconvolutional":
                captured.append(x)
                if i == last_capture:
                    break
            p = f"visumodel.module_list.{i}"
            x = conv(x, W[f"{p}.conv_{i}.weight"], W.get(f"{p}.conv_{i}.bias"),
                     ly.stride, ly.pad, P)
            if ly.bn:
                x = bn(x, W, f"{p}.batch_norm_{i}", train)
            if ly.leaky:
                x = F.leaky_relu(x, 0.1)
        elif ly.type == "upsample":
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        elif ly.type == "route":
            x = torch.cat([saved[s] for s in sources(i, ly)], dim=1)
        elif ly.type == "shortcut":
            x = x + saved[sources(i, ly)[1]]
        if i in need:
            saved[i] = x
    return captured


def mapped_features(W: Weights, g: Geometry, images: torch.Tensor, train: bool = False,
                    P: Prec = FP32) -> List[torch.Tensor]:
    """Per scale (N, C, g, g): the captured maps mapped to the joint width
    (1x1 ConvBNReLU) and l2-normalised over channels."""
    raw = backbone(W, g, images, train, P)
    return [l2n(cbr(raw[s], W, f"mapping_visu.{s}", train, P), dim=1) for s in range(3)]


def attend(q: torch.Tensor, kv: torch.Tensor, t: float, P: Prec) -> torch.Tensor:
    """q, kv (B, P, C): softmax(t q kvᵀ) kv."""
    logits = torch.matmul(P.a(q), P.a(kv).transpose(1, 2)) * t
    return torch.matmul(P.a(torch.softmax(logits, dim=-1)), P.a(kv))


def corr_features(W: Weights, g: Geometry, per_frame: Sequence[torch.Tensor],
                  P: Prec = FP32) -> List[torch.Tensor]:
    """per_frame: per scale (B, n, C, h, w), frames in temporal order. The
    center frame co-attends to each other frame; [center, attended] goes
    through corr_conv, is l2-normalised, and the references are averaged.
    Returns per scale (B, C, h, w)."""
    out = []
    for s, f in enumerate(per_frame):
        b, n, c, h, w = f.shape
        ctr = n // 2
        cen = f[:, ctr].reshape(b, c, h * w).transpose(1, 2)
        acc = 0.0
        for j in range(n):
            if j == ctr:
                continue
            ref = f[:, j].reshape(b, c, h * w).transpose(1, 2)
            att = attend(cen, ref, g.coattn_temperature, P).transpose(1, 2).reshape(b, c, h, w)
            cf = cbr(torch.cat([f[:, ctr], att], dim=1), W, f"corr_conv.{s}.0", False, P)
            acc = acc + l2n(cf, dim=1)
        out.append(acc / (n - 1))
    return out


# ---------------------------------------------------------------------------
# language
# ---------------------------------------------------------------------------

def _lstm_dir(x: torch.Tensor, lengths: torch.Tensor, W: Weights, sfx: str, reverse: bool,
              P: Prec) -> torch.Tensor:
    """One direction of the LSTM over each sequence's first `lengths`
    positions (zeros after them). x (B, L, D) -> (B, L, H)."""
    b, L, _ = x.shape
    wih, whh = W[f"textmodel.rnn.weight_ih_l0{sfx}"], W[f"textmodel.rnn.weight_hh_l0{sfx}"]
    bias = W[f"textmodel.rnn.bias_ih_l0{sfx}"] + W[f"textmodel.rnn.bias_hh_l0{sfx}"]
    hdim = whh.shape[1]
    xi = linear(x, wih, None, P)                                 # (B, L, 4H)
    h = x.new_zeros(b, hdim)
    c = x.new_zeros(b, hdim)
    outs = [None] * L
    steps = range(L - 1, -1, -1) if reverse else range(L)
    for t in steps:
        gates = xi[:, t] + linear(h, whh, None, P) + bias
        i_, f_, g_, o_ = gates.chunk(4, dim=1)
        c_new = torch.sigmoid(f_) * c + torch.sigmoid(i_) * torch.tanh(g_)
        h_new = torch.sigmoid(o_) * torch.tanh(c_new)
        on = (t < lengths)[:, None]
        # a reversed sequence starts at its own last token
        c = torch.where(on, c_new, c)
        h = torch.where(on, h_new, h)
        outs[t] = torch.where(on, h_new, torch.zeros_like(h_new))
    return torch.stack(outs, dim=1)


def bilstm(W: Weights, g: Geometry, ids: torch.Tensor, train: bool = False,
           P: Prec = FP32) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sentence (B, 2H): the output at each phrase's last token,
    context (B, L, 2H), embedded (B, L, D))."""
    lengths = torch.clamp((ids != 0).sum(dim=1), min=1)
    e = W["textmodel.embedding.weight"][ids.long()]
    e = dropout(e, g.input_dropout, train)
    emb = F.relu(linear(e, W["textmodel.mlp.0.weight"], W["textmodel.mlp.0.bias"], P))
    ctx = torch.cat([_lstm_dir(emb, lengths, W, "", False, P),
                     _lstm_dir(emb, lengths, W, "_reverse", True, P)], dim=-1)
    last = ctx[torch.arange(ids.shape[0], device=ids.device), lengths - 1]
    return last, ctx, emb


def bert(W: Weights, g: Geometry, ids: torch.Tensor, P: Prec = FP32
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The BERT body (dropout off: it is frozen) and the trained projection:
    (sentence: the mean of the last four layers' [CLS] (B, H), context:
    the last layer (B, L, H), embedded: its projection (B, L, emb))."""
    b = g.bert
    ids = ids.long()
    mask = (ids != 0).float()
    pos = torch.arange(ids.shape[1], device=ids.device)
    e = "textmodel.embeddings"
    x = (W[f"{e}.word_embeddings.weight"][ids] + W[f"{e}.position_embeddings.weight"][pos][None]
         + W[f"{e}.token_type_embeddings.weight"][torch.zeros_like(ids)])

    def ln(x, p):
        return F.layer_norm(x, (x.shape[-1],), W[f"{p}.weight"], W[f"{p}.bias"], b.layer_norm_eps)

    def lin(x, p):
        return linear(x, W[f"{p}.weight"], W[f"{p}.bias"], P)

    x = ln(x, f"{e}.LayerNorm")
    bias = (1.0 - mask[:, None, None, :]) * -10000.0
    hd = b.hidden_size // b.num_heads
    n, L = ids.shape
    states = []
    for li in range(b.num_layers):
        p = f"textmodel.encoder.layer.{li}"

        def heads(t):
            return t.reshape(n, L, b.num_heads, hd).transpose(1, 2)

        q, k, v = (heads(lin(x, f"{p}.attention.self.{m}")) for m in ("query", "key", "value"))
        probs = torch.softmax(P.a(q) @ P.a(k).transpose(-1, -2) / math.sqrt(hd) + bias, dim=-1)
        a = (P.a(probs) @ P.a(v)).transpose(1, 2).reshape(n, L, b.hidden_size)
        x = ln(x + lin(a, f"{p}.attention.output.dense"), f"{p}.attention.output.LayerNorm")
        inter = F.gelu(lin(x, f"{p}.intermediate.dense"))
        x = ln(x + lin(inter, f"{p}.output.dense"), f"{p}.output.LayerNorm")
        states.append(x)
    sentence = sum(h[:, 0] for h in states[-4:]) / 4.0
    ctx = states[-1]
    return sentence, ctx, lin(ctx, "textmodel.proj")


def language(W: Weights, g: Geometry, ids: torch.Tensor, train: bool = False,
             P: Prec = FP32):
    """(flang (B, emb): the sentence mapped and l2-normalised, context,
    embedded)."""
    if g.text_encoder == "bilstm":
        sent, ctx, emb = bilstm(W, g, ids, train, P)
    else:
        with torch.no_grad():
            sent, ctx, _ = bert(W, g, ids, P)
        emb = linear(ctx, W["textmodel.proj.weight"], W["textmodel.proj.bias"], P)
    x = sent
    for i, (li, bi) in enumerate(((0, 1), (4, 5))):
        if i == 1:
            x = dropout(x, g.jemb_dropout, train)
        x = linear(x, W[f"mapping_lang.{li}.weight"], W[f"mapping_lang.{li}.bias"], P)
        x = F.relu(bn(x, W, f"mapping_lang.{bi}", train))
    return l2n(x), ctx, emb


def phrase_attention(W: Weights, name: str, ctx: torch.Tensor, emb: torch.Tensor,
                     ids: torch.Tensor, P: Prec) -> torch.Tensor:
    """Softmax of a one-unit scorer over the words, zero at padding,
    renormalised; the weighted sum of the word embeddings (B, E)."""
    scores = linear(ctx, W[f"{name}.fc.weight"], W[f"{name}.fc.bias"], P)[..., 0]
    a = torch.softmax(scores, dim=-1) * (ids != 0).float()
    a = a / (a.sum(dim=1, keepdim=True) + 1e-12)
    return torch.einsum("bl,ble->be", a, emb)


# ---------------------------------------------------------------------------
# the trunk
# ---------------------------------------------------------------------------

class Trunk(NamedTuple):
    outbox: List[torch.Tensor]     # per scale (B, 3, 5, g, g), conf modulated
    sim: List[torch.Tensor]        # per scale (B, g, g)
    loc: List[torch.Tensor]        # per scale (B, g, g)
    flang_attn: torch.Tensor       # (B, E)


def trunk(W: Weights, g: Geometry, corr: Sequence[torch.Tensor], lang, ids: torch.Tensor,
          train: bool = False, P: Prec = FP32) -> Trunk:
    """corr: per scale (B, C, h, w)."""
    flang, ctx, emb = lang
    b = corr[0].shape[0]
    coords = [coord_map(f.shape[2], f.shape[3], f.device) for f in corr]
    outbox = []
    for s, f in enumerate(corr):
        h, w = f.shape[2:]
        x = torch.cat([f, flang[:, :, None, None].expand(b, flang.shape[1], h, w),
                       coords[s][None].expand(b, 8, h, w)], dim=1)
        for j in range(3):
            x = cbr(x, W, f"fcn_emb.{s}.{j}", train, P)
        x = cbr(x, W, f"fcn_out.{s}.0", train, P)
        x = conv(x, W[f"fcn_out.{s}.1.weight"], W[f"fcn_out.{s}.1.bias"], 1, 0, P)
        outbox.append(x.reshape(b, 3, 5, h, w))
    flang_attn = l2n(phrase_attention(W, "sub_attn", ctx, emb, ids, P))
    sim = [torch.einsum("bc,bchw->bhw", flang_attn, f) for f in corr]
    obj = [ob[:, :, 4].mean(dim=1) * ss for ob, ss in zip(outbox, sim)]
    flang_loc = l2n(phrase_attention(W, "loc_attn", ctx, emb, ids, P))
    cmap = torch.cat([c.reshape(8, -1).t() for c in coords], dim=0)          # (Pa, 8)
    obj_map = l2n(torch.cat([o.reshape(b, -1) for o in obj], dim=1))          # (B, Pa)
    ce = linear(cmap, W["loc_embedding.0.weight"], W["loc_embedding.0.bias"], P)
    ce = F.relu(bn(ce.expand(b, *ce.shape).reshape(-1, 8), W, "loc_embedding.1", train))
    ce = l2n(ce.reshape(b, -1, 8), dim=2)                                    # (B, Pa, 8)
    gram = torch.matmul(ce, ce.transpose(1, 2)) * obj_map[:, None, :]        # (B, Pa, Pa)
    rel = linear(gram, W["loc_text_embedding.0.weight"], W["loc_text_embedding.0.bias"], P)
    rel = F.relu(bn(rel.reshape(-1, rel.shape[-1]), W, "loc_text_embedding.1", train))
    rel = l2n(rel.reshape(b, g.all_positions, -1), dim=2)
    loc_map = torch.einsum("bpc,bc->bp", rel, flang_loc)
    lo = loc_map.min(dim=1, keepdim=True).values
    hi = loc_map.max(dim=1, keepdim=True).values
    loc_map = (loc_map - lo) / (hi - lo + 1e-6)
    loc, s0 = [], 0
    for f in corr:
        h, w = f.shape[2:]
        loc.append(loc_map[:, s0:s0 + h * w].reshape(b, h, w))
        s0 += h * w
    mod = []
    for ob, ss, ls in zip(outbox, sim, loc):
        conf = ob[:, :, 4] * (ss * ls)[:, None]
        mod.append(torch.cat([ob[:, :, :4], conf[:, :, None]], dim=2))
    return Trunk(mod, sim, loc, flang_attn)


# ---------------------------------------------------------------------------
# decode and fusion
# ---------------------------------------------------------------------------

class Candidates(NamedTuple):
    """Every anchor of every cell, in the flat order of the conf vector
    (per scale: anchor, row, column)."""

    boxes: torch.Tensor   # (B, A, 4) xyxy pixels
    conf: torch.Tensor    # (B, A)
    scale: torch.Tensor   # (A,)
    cell: torch.Tensor    # (A,) row * g + column at its scale


def candidates(g: Geometry, outbox: Sequence[torch.Tensor]) -> Candidates:
    boxes, confs, scales, cells = [], [], [], []
    for s, o in enumerate(outbox):
        b, _, _, gh, gw = o.shape
        stride = g.strides[s]
        anchors = torch.tensor(g.scaled_anchors(s), dtype=torch.float32, device=o.device)
        gj = torch.arange(gh, device=o.device)[None, None, :, None].float()
        gi = torch.arange(gw, device=o.device)[None, None, None, :].float()
        cx = (torch.sigmoid(o[:, :, 0]) + gi) * stride
        cy = (torch.sigmoid(o[:, :, 1]) + gj) * stride
        bw = torch.exp(o[:, :, 2]) * anchors[None, :, 0, None, None] * stride
        bh = torch.exp(o[:, :, 3]) * anchors[None, :, 1, None, None] * stride
        xyxy = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1)
        boxes.append(xyxy.reshape(b, -1, 4))
        confs.append(o[:, :, 4].reshape(b, -1))
        n = 3 * gh * gw
        scales.append(torch.full((n,), s, device=o.device))
        cells.append(torch.arange(gh * gw, device=o.device).repeat(3))
    return Candidates(torch.cat(boxes, 1), torch.cat(confs, 1), torch.cat(scales),
                      torch.cat(cells))


def topk_order(conf: torch.Tensor, k: int) -> torch.Tensor:
    """The k highest confidences, ties to the lower index."""
    return torch.sort(conf, dim=-1, descending=True, stable=True).indices[..., :k]


def candidate_feats(cand: Candidates, corr: Sequence[torch.Tensor], idx: torch.Tensor
                    ) -> torch.Tensor:
    """The fused feature at each chosen candidate's cell: idx (B, K) ->
    (B, K, C)."""
    b, k = idx.shape
    c = corr[0].shape[1]
    out = torch.zeros((b, k, c), device=idx.device)
    for s, f in enumerate(corr):
        flat = f.reshape(b, c, -1).transpose(1, 2)                   # (B, g^2, C)
        cell = cand.cell[idx]
        vals = torch.gather(flat, 1, torch.clamp(cell, max=flat.shape[1] - 1)[..., None]
                            .expand(b, k, c))
        out = torch.where((cand.scale[idx] == s)[..., None], vals, out)
    return out


def fused_scores(center_feats: torch.Tensor, win_feats: torch.Tensor,
                 win_scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The serving engine's temporal fusion of candidates at the window's
    center: for each candidate i (center_feats (B, I, C)), its best match
    j in each window entry r (win_feats (B, R, K, C)) by feature dot
    product; the match's score, weighted by the softmax over r of the
    match's similarity, entries not yet filled (valid (B, R) false) at
    zero weight. Returns (B, I)."""
    sim = torch.einsum("bic,brjc->birj", center_feats, win_feats)
    sim_max, best = sim.max(dim=3)
    picked = torch.gather(win_scores[:, None].expand(-1, sim.shape[1], -1, -1), 3,
                          best[..., None])[..., 0]
    wgt = torch.softmax(sim_max, dim=2) * valid[:, None, :].float()
    return torch.sum(wgt * picked, dim=2)


# ---------------------------------------------------------------------------
# training: the k=2 forward, its samples and the losses
# ---------------------------------------------------------------------------

def _negatives(gen: torch.Generator, pos: torch.Tensor, n_items: int, n: int) -> torch.Tensor:
    """n indices of [0, n_items) without replacement, never `pos`: the
    largest of uniform draws, the positive's pushed below all."""
    u = torch.rand(pos.shape + (n_items,), generator=gen, device=pos.device)
    u = u - 2.0 * F.one_hot(pos.long(), n_items).to(u.dtype)
    return topk_order(u, n)


def _rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    b, _, c = feats.shape
    flat = idx.reshape(b, -1).long()
    return torch.gather(feats, 1, flat[..., None].expand(b, flat.shape[1], c)).reshape(
        *idx.shape, c)


def _infonce(q, k, neg, t: float) -> torch.Tensor:
    q, k, neg = l2n(q), l2n(k), l2n(neg)
    l_neg = torch.einsum("bkc,bknc->bkn", q, neg)
    l_pos = torch.einsum("bkc,bkpc->bkp", q, k)
    logits = torch.cat([l_pos[..., None],
                        l_neg[:, :, None, :].expand(*l_pos.shape, l_neg.shape[-1])], -1) / t
    return -torch.mean(torch.log_softmax(logits, dim=-1)[..., 0])


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.gather(torch.log_softmax(logits, -1), -1, labels[:, None])[:, 0])


def targets(g: Geometry, bbox: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The ground truth matched to its best anchor (by the IoU of widths
    and heights) and cell."""
    size = float(g.image_size)
    box = torch.clamp(bbox.float(), 0, g.image_size - 1)
    cx, cy = (box[:, 0] + box[:, 2]) / (2 * size), (box[:, 1] + box[:, 3]) / (2 * size)
    w, h = (box[:, 2] - box[:, 0]) / size, (box[:, 3] - box[:, 1]) / size
    an = torch.tensor(g.anchors(), dtype=torch.float32, device=box.device) / g.anchor_imsize
    inter = torch.minimum(w[:, None], an[None, :, 0]) * torch.minimum(h[:, None], an[None, :, 1])
    iou = inter / (w[:, None] * h[:, None] + an[None, :, 0] * an[None, :, 1] - inter + 1e-16)
    best_n = torch.argmax(iou, dim=1)
    scale, anchor = best_n // 3, best_n % 3
    gsz = torch.tensor(g.grids, device=box.device)[scale]
    gx, gy = cx * gsz, cy * gsz
    gi = torch.minimum(gx.long().clamp(min=0), gsz - 1)
    gj = torch.minimum(gy.long().clamp(min=0), gsz - 1)
    tw = torch.log(w * gsz / (an[best_n, 0] * gsz) + 1e-16)
    th = torch.log(h * gsz / (an[best_n, 1] * gsz) + 1e-16)
    conf_off = torch.tensor([0, 3 * g.grids[0] ** 2, 3 * (g.grids[0] ** 2 + g.grids[1] ** 2)],
                            device=box.device)
    pos_off = torch.tensor([0, g.grids[0] ** 2, g.grids[0] ** 2 + g.grids[1] ** 2],
                           device=box.device)
    return {"scale": scale, "anchor": anchor, "gi": gi, "gj": gj,
            "txywh": torch.stack([gx - gi, gy - gj, tw, th], -1),
            "conf_idx": conf_off[scale] + anchor * gsz * gsz + gj * gsz + gi,
            "pos_idx": pos_off[scale] + gj * gsz + gi}


def train_losses(W: Weights, g: Geometry, images: torch.Tensor, ids: torch.Tensor,
                 bbox: torch.Tensor, gen: torch.Generator, P: Prec = FP32
                 ) -> Dict[str, torch.Tensor]:
    """The training forward on k=2 clips (images (2B, H, W, 3), frame
    pairs adjacent; ids (2B, L); bbox (2B, 4) xyxy) and its five losses.
    Dropout draws from the device's default generator and the contrastive
    negatives from `gen`, in the order the model draws them."""
    bk = images.shape[0]
    b = bk // 2
    fv = mapped_features(W, g, images, True, P)           # per scale (2B, C, h, w)
    top_k, neg_n, cm_neg = g.sampling()
    c = g.emb_size
    pf = [f.reshape(b, 2, c, -1).transpose(2, 3) for f in fv]   # (B, 2, P, C)
    with torch.no_grad():
        p0 = pf[0].shape[2]
        corr = torch.einsum("bpc,bqc->bpq", pf[0][:, 0], pf[0][:, 1]).reshape(b, -1)
        idx = topk_order(corr, top_k)
    qi, ki = idx // p0, idx % p0
    negs = _negatives(gen, ki, p0, neg_n)
    inter = (_rows(pf[0][:, 0], qi), _rows(pf[0][:, 1], ki)[:, :, None], _rows(pf[0][:, 1], negs))
    corr_feat = []
    for s, f in enumerate(fv):
        h, w = f.shape[2:]
        a1 = attend(pf[s][:, 0], pf[s][:, 1], g.coattn_temperature, P)
        a2 = attend(pf[s][:, 1], pf[s][:, 0], g.coattn_temperature, P)
        att = torch.stack([a1, a2], 1).reshape(bk, -1, c).transpose(1, 2).reshape(bk, c, h, w)
        corr_feat.append(l2n(cbr(torch.cat([f, att], 1), W, f"corr_conv.{s}.0", True, P), 1))
    lang = language(W, g, ids, True, P)
    tr = trunk(W, g, corr_feat, lang, ids, True, P)
    _, ctx, emb = lang
    vit = l2n(fv[0].reshape(bk, c, -1), dim=2)                        # (kB, C, P)
    lwords = l2n(ctx[:, :, ::2] if g.text_encoder == "bilstm" else emb, dim=1)
    wp = torch.einsum("blc,bcp->blp", lwords, vit)
    wp = torch.softmax(F.conv1d(wp, W["feature_map.0.weight"], W["feature_map.0.bias"],
                                padding=1), dim=1)
    with torch.no_grad():
        cols = topk_order(wp.transpose(1, 2), g.crossmodal_top_k)
    pv = vit.shape[2]
    cneg = _negatives(gen, torch.arange(pv, device=vit.device).expand(bk, pv), pv, cm_neg)
    vt = vit.transpose(1, 2)
    cross = (vt, _rows(lwords, cols), _rows(vt, cneg))

    t = targets(g, bbox)
    rows = torch.arange(bk, device=images.device)
    picked = torch.zeros((bk, 5), device=images.device)
    for s, o in enumerate(tr.outbox):
        gs = g.grids[s]
        cell = torch.clamp(t["gj"], 0, gs - 1) * gs + torch.clamp(t["gi"], 0, gs - 1)
        vals = o.reshape(bk, 3, 5, gs * gs)[rows, t["anchor"], :, cell]
        picked = torch.where((t["scale"] == s)[:, None], vals, picked)
    l_xy = torch.mean(torch.square(torch.sigmoid(picked[:, :2]) - t["txywh"][:, :2]), 0)
    l_wh = torch.mean(torch.square(picked[:, 2:4] - t["txywh"][:, 2:4]), 0)
    conf = torch.cat([o[:, :, 4].reshape(bk, -1) for o in tr.outbox], 1)
    yolo = (l_xy.sum() + l_wh.sum()) * g.yolo_coord_weight + _ce(conf, t["conf_idx"])
    sim = torch.cat([s_.reshape(bk, -1) for s_ in tr.sim], 1)
    rev = torch.flip(tr.flang_attn, [0])
    nsim = torch.cat([torch.einsum("bc,bchw->bhw", rev, f).reshape(bk, -1) for f in corr_feat], 1)
    pidx = t["pos_idx"][:, None]
    pos = torch.gather(sim, 1, pidx)[:, 0]
    neg1 = torch.gather(nsim, 1, pidx)[:, 0]
    neg2 = torch.gather(sim, 1, torch.flip(pidx, [0]))[:, 0]
    rank = (F.relu(g.rank_margin + neg1 - pos) + F.relu(g.rank_margin + neg2 - pos)).sum() / (2 * bk)
    loc = _ce(torch.cat([s_.reshape(bk, -1) for s_ in tr.loc], 1), t["pos_idx"])
    l_inter = _infonce(*inter, g.infonce_temperature)
    l_cross = _infonce(*cross, g.infonce_temperature)
    total = (yolo + g.w_rank * rank + g.w_loc * loc + g.w_interframe * l_inter
             + g.w_crossmodal * l_cross)
    return {"loss": total, "loss_yolo": yolo, "loss_rank": rank, "loss_loc": loc,
            "loss_interframe": l_inter, "loss_crossmodal": l_cross}


def rmsprop_step(W: Weights, sq: Weights, grads: Weights, g: Geometry) -> Weights:
    """One RMSprop step (alpha 0.99, eps 1e-8, decay folded into the
    gradient before the square average), the backbone at lr times its
    scale. Updates W and sq in place; returns the gradients as the
    optimizer took them (decay included)."""
    seen = {}
    for name, grad in grads.items():
        p = W[name]
        d = grad + g.weight_decay * p
        sq[name].mul_(g.rmsprop_alpha).addcmul_(d, d, value=1 - g.rmsprop_alpha)
        lr = g.lr * (g.backbone_lr_scale if name.startswith("visumodel.") else 1.0)
        p.sub_(lr * d / (sq[name].sqrt() + g.rmsprop_eps))
        seen[name] = d
    return seen
