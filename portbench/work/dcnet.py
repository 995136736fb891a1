"""The work of DCNet, counted from the configuration's shapes: operations
by precision per unit of traffic (a served tick, an eval call, a training
step) and each hand-written kernel's least time per unit. The counts do
not depend on what implements them.

Counted: the products of the live backbone convolutions (those whose
outputs reach a captured map), the mapping convs, co-attention (4 B P^2 C
per direction and reference: the logits and the weighted sum), corr_conv
on [center, attended] per reference, the fusion trunk's convs and head,
the subject-similarity map, the location embedding on its rank-8
coordinate factors, and the text encoder's matmuls; the backward pass as
twice its forward products, and co-attention's as its five products
(10 B P^2 C per direction). Element-wise work is not counted.
"""

from __future__ import annotations

from typing import Dict

from portbench.reference.geometry import Geometry, conv_shapes, live
from portbench.work.peaks import ITEMSIZE, PEAK_FLOPS, least_seconds


def conv_flops(k: int, stride: int, pad: int, ci: int, co: int, side: int) -> float:
    ho = (side + 2 * pad - k) // stride + 1
    return 2.0 * ho * ho * k * k * ci * co


def backbone_convs(g: Geometry, live_only: bool = True, size: int = 0):
    """(k, stride, pad, Ci, Co, side) of the backbone's convs."""
    layers = g.layers()
    keep = live(layers) if live_only else None
    return [c[1:] for c in conv_shapes(layers, size or g.image_size)
            if keep is None or c[0] in keep]


def backbone_flops(g: Geometry, live_only: bool = True, size: int = 0) -> float:
    """One frame's backbone operations."""
    return sum(conv_flops(*c) for c in backbone_convs(g, live_only, size))


def captured_channels(g: Geometry):
    return [ly.in_ch for ly in g.layers() if ly.type == "yoloconvolutional"]


def mapping_flops(g: Geometry) -> float:
    return sum(2.0 * gs * gs * c * g.emb_size for gs, c in zip(g.grids, captured_channels(g)))


def coattn_flops(g: Geometry, scale: int) -> float:
    """One direction, one reference: 4 P^2 C."""
    p = g.grids[scale] ** 2
    return 4.0 * p * p * g.emb_size


def corr_conv_flops(g: Geometry, scale: int) -> float:
    """corr_conv on one [center, attended] pair."""
    return 2.0 * g.grids[scale] ** 2 * 2 * g.emb_size * g.emb_size


def fcn_convs(g: Geometry):
    """(k, Ci, Co) of one scale's fusion convs, head last."""
    c = g.emb_size
    return [(1, 2 * c + 8, c), (3, c, c), (1, c, c), (1, c, c // 2), (1, c // 2, 15)]


def trunk_flops(g: Geometry) -> float:
    """The fusion trunk, the similarity map and the location embedding on
    one center frame."""
    c, pa = g.emb_size, g.all_positions
    fcn = sum(2.0 * gs * gs * k * k * ci * co for gs in g.grids for k, ci, co in fcn_convs(g))
    return fcn + 2.0 * pa * c + 4.0 * 8 * pa * c


def text_flops(g: Geometry) -> float:
    """One phrase through the text encoder and the language mapping."""
    L, c, td = g.query_len, g.emb_size, g.textdim
    if g.text_encoder == "bilstm":
        h, wv = g.lstm_hidden, td // 2
        enc = 2.0 * L * g.word_embedding_size * wv + 2 * L * 2.0 * 4 * h * (wv + h)
    else:
        b = g.bert
        hs, i = b.hidden_size, b.intermediate_size
        per_layer = 2.0 * L * hs * 4 * hs + 4.0 * L * L * hs + 4.0 * L * hs * i
        enc = b.num_layers * per_layer + 2.0 * L * hs * c
    return enc + 2.0 * (td * c + c * c)


def center_flops(g: Geometry, refs: int):
    """(attention, other) operations of grounding one center frame against
    `refs` references."""
    att = sum(refs * coattn_flops(g, s) for s in range(3))
    return att, sum(refs * corr_conv_flops(g, s) for s in range(3)) + trunk_flops(g)


# --- kernel bounds (seconds per call of the shapes given) -------------------

def attend_seconds(b: int, p: int, c: int, prec: str, directions: int = 1) -> float:
    """K1 (one direction) / K2 (two): 4 B P^2 C operations and 3 B P C
    elements moved per direction."""
    return least_seconds({prec: directions * 4.0 * b * p * p * c},
                         directions * 3.0 * b * p * c * ITEMSIZE[prec])


def attend_bwd_seconds(b: int, p: int, c: int, prec: str) -> float:
    """K3: five products of 2 B P^2 C (fp32 inputs: all at 3xTF32; bf16:
    two bf16 x bf16, three with an fp32 operand) and 5 B P C elements."""
    one = 2.0 * b * p * p * c
    ops = {"fp32": 5 * one} if prec == "fp32" else {"bf16": 2 * one, "fp32xbf16": 3 * one}
    return least_seconds(ops, 5.0 * b * p * c * ITEMSIZE[prec])


def ring_seconds(b: int, s: int, p: int, c: int, prec: str) -> float:
    """K4: 4 B (S-1) P^2 C operations (int8 rings: the logits at the int8
    peak, the weighted sum at bf16's), B S P C elements read and B (S-1) P
    C written (bf16 for int8 rings)."""
    ops = 4.0 * b * (s - 1) * p * p * c
    out = "bf16" if prec == "int8" else prec
    nbytes = b * p * c * (s * ITEMSIZE[prec] + (s - 1) * ITEMSIZE[out])
    split = {"int8": ops / 2, "bf16": ops / 2} if prec == "int8" else {prec: ops}
    return least_seconds(split, nbytes)


def conv_s8_seconds(n: int, k: int, stride: int, pad: int, ci: int, co: int, side: int,
                    in_prec: str, out_prec: str) -> float:
    """K6 with its quantize pass: 2 N Ho Wo k^2 Ci Co operations at the
    int8 peak; x read once in the type the path hands it, w (int8) and the
    epilogue's four fp32 vectors read once, the output written once."""
    ho = (side + 2 * pad - k) // stride + 1
    nbytes = (n * side * side * ci * ITEMSIZE[in_prec] + co * k * k * ci + 16 * co
              + n * ho * ho * co * ITEMSIZE[out_prec])
    return least_seconds({"int8": 2.0 * n * ho * ho * k * k * ci * co}, nbytes)


# --- per unit -----------------------------------------------------------------

def _add(d: Dict[str, float], prec: str, ops: float) -> None:
    d[prec] = d.get(prec, 0.0) + ops


def serve_tick(g: Geometry, t: dict) -> dict:
    """A served tick of N streams: the backbone and mapping on N new
    frames, each center grounded against n - 1 references."""
    n, refs = t["streams"], g.n_frames_test - 1
    int8 = bool(t.get("quantize"))
    ring = "int8" if t.get("int8_rings") else "bf16"
    att, other = center_flops(g, refs)
    head = sum(2.0 * gs * gs * (g.emb_size // 2) * 15 for gs in g.grids)
    ops: Dict[str, float] = {}
    _add(ops, "int8" if int8 else "bf16", n * (backbone_flops(g) + mapping_flops(g)
                                               + other - head))
    _add(ops, "bf16", n * head)
    if ring == "int8":
        _add(ops, "int8", n * att / 2)
        _add(ops, "bf16", n * att / 2)
    else:
        _add(ops, "bf16", n * att)
    kernels = {"k4": sum(ring_seconds(n, g.n_frames_test, gs * gs, g.emb_size, ring)
                         for gs in g.grids)}
    if int8:
        k6 = 0.0
        for j, c in enumerate(backbone_convs(g)):
            k6 += conv_s8_seconds(n, *c, "fp32" if j == 0 else "bf16", "bf16")
        c = g.emb_size
        for gs, ci in zip(g.grids, captured_channels(g)):
            k6 += conv_s8_seconds(n, 1, 1, 0, ci, c, gs, "bf16", "bf16")           # mapping
            k6 += refs * conv_s8_seconds(n, 1, 1, 0, 2 * c, c, gs, "bf16", "bf16")  # corr_conv
            for k, ci_, co in fcn_convs(g)[:-1]:
                k6 += conv_s8_seconds(n, k, 1, (k - 1) // 2, ci_, co, gs, "bf16", "bf16")
        kernels["k6"] = k6
    return {"ops": ops, "kernels": kernels}


def eval_call(g: Geometry, t: dict) -> dict:
    """An eval call of B clips: the backbone on B n frames, B centers each
    against n - 1 references, B phrases."""
    b, n = t["clips"], g.n_frames_test
    att, other = center_flops(g, n - 1)
    total = b * (n * (backbone_flops(g) + mapping_flops(g)) + att + other + text_flops(g))
    k1 = sum((n - 1) * attend_seconds(b, gs * gs, g.emb_size, "bf16") for gs in g.grids)
    return {"ops": {"bf16": total}, "kernels": {"k1": k1}}


def train_step(g: Geometry, t: dict) -> dict:
    """A training step of B k=2 clips: forward on 2B frames, both
    directions of co-attention per clip and scale, corr_conv and the trunk
    on 2B frames, 2B phrases; backward at twice the forward's products
    (co-attention's five), the frozen BERT body's left out."""
    b, k = t["clips"], g.n_frames_train
    frames = b * k
    att = sum(b * 2 * coattn_flops(g, s) for s in range(3))
    convs = frames * (backbone_flops(g) + mapping_flops(g) + trunk_flops(g)
                      + sum(corr_conv_flops(g, s) for s in range(3)))
    text = frames * text_flops(g)
    total = 3 * convs + att * (1 + 2.5)
    if g.text_encoder == "bilstm":
        total += 3 * text
    else:
        total += text
    k3 = sum(2 * attend_bwd_seconds(b, gs * gs, g.emb_size, "fp32") for gs in g.grids)
    return {"ops": {"fp32": total}, "kernels": {"k3": k3}}


UNITS = {"serve": serve_tick, "eval": eval_call, "train": train_step}


def unit_work(g: Geometry, traffic: dict) -> dict:
    """{"ops": {precision: operations}, "kernels": {kernel: least seconds}}
    for one unit of the traffic."""
    return UNITS[traffic["loop"]](g, traffic)


def least_unit_seconds(work: dict) -> float:
    """The unit's operations at their precisions' peaks."""
    return sum(ops / PEAK_FLOPS[p] for p, ops in work["ops"].items())
