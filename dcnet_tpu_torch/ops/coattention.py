"""Co-attention between two frames, in einsum form.

The port of `dcnet_tpu/ops/coattention.py::coattention_center` (the center
frame attended to one reference frame,

    out = softmax_q(T <center_p, ref_q>) @ ref)

and `coattention_pair` (both directions off one logits matrix), with the
einsum's dtype rules (logits and softmax in the input dtype). The model
runs the same functions through kernels K1 and K2
(`kernels.coattn.coattention_center_fused`, `coattention_pair_fused`); this
form is the composition the JAX package falls back to off the TPU. The
sharding annotation (`tp_shard`) and the int8 logits are not ported yet
(ROADMAP queue A, items 12 and 9).
"""

from __future__ import annotations

from typing import Tuple

import torch


def coattention_center(center: torch.Tensor, ref: torch.Tensor,
                       temperature: float = 10.0) -> torch.Tensor:
    """center, ref: (B, H, W, C) -> attended features for the center (NHWC)."""
    b, h, w, c = center.shape
    k = center.reshape(b, h * w, c)
    v = ref.reshape(b, h * w, c)
    logits = torch.einsum("bpc,bqc->bpq", k, v) * temperature
    attn = torch.softmax(logits, dim=2)
    return torch.einsum("bqc,bpq->bpc", v, attn).reshape(b, h, w, c)


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
