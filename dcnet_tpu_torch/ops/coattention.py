"""Single-direction co-attention between two frames, in einsum form.

The port of `dcnet_tpu/ops/coattention.py::coattention_center`: the center
frame attended to one reference frame,

    out = softmax_q(T <center_p, ref_q>) @ ref,

with the einsum's dtype rules (logits and softmax in the input dtype). The
model runs the same function through kernel K1
(`kernels.coattn.coattention_center_fused`); this form is the composition
the JAX package falls back to off the TPU. The sharding annotation
(`tp_shard`) and the int8 logits are not ported yet (ROADMAP queue A,
items 12 and 9).
"""

from __future__ import annotations

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
