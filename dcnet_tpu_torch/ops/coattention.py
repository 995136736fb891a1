"""Co-attention between two frames, in einsum form.

The port of `dcnet_tpu/ops/coattention.py::coattention_center` (the center
frame attended to one reference frame,

    out = softmax_q(T <center_p, ref_q>) @ ref)

and `coattention_pair` (both directions off one logits matrix), with the
einsum's dtype rules (logits and softmax in the input dtype). The model
runs the same functions through kernels K1 and K2
(`kernels.coattn.coattention_center_fused`, `coattention_pair_fused`); this
form is the composition the JAX package falls back to off the TPU. The eval
path's opt-in variants stay torch products here, as the JAX package leaves
them to XLA outside any Pallas kernel: the int8 QK logits
(`coattention_center(int8_logits=True)`, `cfg.coattn_int8_logits`) and
every reference in one batched einsum (`coattention_center_batched`,
`cfg.coattn_batch_refs`). The sharding annotation (`tp_shard`) is not
ported yet (ROADMAP queue A, item 12).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _int8_logits(k: torch.Tensor, v: torch.Tensor, eq: str,
                 temperature: float) -> torch.Tensor:
    """T <k_p, v_q> on int8 codes: both sides quantised with the static
    scale 1/127 (`clamp(round(127 x))`; the features are l2-normalised per
    position, so |x| <= 1 needs no calibration), their integer products
    summed, the sums dequantised by T / 127^2 in fp32, then cast to k's
    dtype, as the JAX package does. The sums run as an fp32 einsum on the
    integer codes, which is exact here: the codes are integers <= 127 (exact
    in bf16, TF32 and fp32), each product <= 127^2, and by Cauchy-Schwarz
    every partial sum is at most ||kq|| ||vq|| <= (127 + sqrt(C) / 2)^2
    (~1.9e4 at C = 512), far below 2^24. That bound rests on l2-normalised
    inputs."""
    kq = torch.clamp(torch.round(k.float() * 127.0), -127, 127)
    vq = torch.clamp(torch.round(v.float() * 127.0), -127, 127)
    raw = torch.einsum(eq, kq, vq)
    return (raw * (temperature / (127.0 * 127.0))).to(k.dtype)


def coattention_center(center: torch.Tensor, ref: torch.Tensor,
                       temperature: float = 10.0,
                       int8_logits: bool = False) -> torch.Tensor:
    """center, ref: (B, H, W, C) -> attended features for the center (NHWC).
    `int8_logits` takes the logits from int8 codes (`_int8_logits`)."""
    b, h, w, c = center.shape
    k = center.reshape(b, h * w, c)
    v = ref.reshape(b, h * w, c)
    if int8_logits:
        logits = _int8_logits(k, v, "bpc,bqc->bpq", temperature)
    else:
        logits = torch.einsum("bpc,bqc->bpq", k, v) * temperature
    attn = torch.softmax(logits, dim=2)
    return torch.einsum("bqc,bpq->bpc", v, attn).reshape(b, h, w, c)


def coattention_center_batched(center: torch.Tensor, refs: torch.Tensor,
                               temperature: float = 10.0,
                               int8_logits: bool = False) -> torch.Tensor:
    """Every reference in one einsum: center (B, H, W, C), refs (B, R, H,
    W, C) -> attended (B, R, H, W, C), row r equal to
    `coattention_center(center, refs[:, r])`; the center block is a
    broadcast operand of the logits product, not copied R times."""
    b, h, w, c = center.shape
    r = refs.shape[1]
    k = center.reshape(b, h * w, c)
    v = refs.reshape(b, r, h * w, c)
    if int8_logits:
        logits = _int8_logits(k, v, "bpc,brqc->brpq", temperature)
    else:
        logits = torch.einsum("bpc,brqc->brpq", k, v) * temperature
    attn = torch.softmax(logits, dim=3)
    out = torch.einsum("brqc,brpq->brpc", v, attn.to(v.dtype))
    return out.reshape(b, r, h, w, c)


def coattention_pair(f1: torch.Tensor, f2: torch.Tensor,
                     temperature: float = 10.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f1, f2: (B, H, W, C) -> (attended_for_f1, attended_for_f2), NHWC: the
    logits T <f1_p, f2_q> softmaxed over q for f1 and over p for f2."""
    b, h, w, c = f1.shape
    k = f1.reshape(b, h * w, c)
    v = f2.reshape(b, h * w, c)
    logits = torch.einsum("bpc,bqc->bpq", k, v) * temperature
    f1_att = torch.einsum("bqc,bpq->bpc", v, torch.softmax(logits, dim=2))
    f2_att = torch.einsum("bpc,bpq->bqc", k, torch.softmax(logits, dim=1))
    return f1_att.reshape(b, h, w, c), f2_att.reshape(b, h, w, c)
