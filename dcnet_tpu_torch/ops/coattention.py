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
`cfg.coattn_batch_refs`).

`tp_shard` is the JAX package's annotation of the (P, P) logits over the
mesh's `model` axis (`P("data", "model", None)`: query rows split), made
explicit: with a model group of more than one rank (`parallel.mesh`), rank
r computes the query rows of its window (`mesh.row_window`; P need not
divide) against all rows of the other frame, through kernels K1 / K2 on
CUDA tensors and their plain versions on the CPU (the kernels' dtype
rules: fp32 logits and softmax, as the JAX einsum has in fp32), and the
windows are all-gathered (`mesh.gather_rows`). The pair's second direction
splits the rows of f2 (the rows of its own output) where the annotation
splits f1's rows of the one logits matrix and softmaxes its columns across
ranks: the function computed is the same. The backward is K3 on each
window: the window's dq, all-gathered, and its partial dkv, summed over the
group (`mesh.all_reduce_sum`); the pair combines them as df1 = dq1 + dkv2,
df2 = dkv1 + dq2, as `kernels.coattn.coattention_fused` does. The int8
logits take the same windows on the einsum form (eval only). Without a
model group of more than one rank, `tp_shard` changes nothing.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dcnet_tpu_torch.kernels import coattn as kc
from dcnet_tpu_torch.parallel import mesh


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


class _CenterTP(torch.autograd.Function):
    """K1 on this rank's query rows, K3 backward: the window's dq
    all-gathered, its partial dkv summed over the model group."""

    @staticmethod
    def forward(ctx, q, kv, temperature, group):
        ctx.row0, rows = mesh.group_window(q.shape[1], group)
        ctx.temperature, ctx.group = temperature, group
        ctx.save_for_backward(q, kv)
        return kc.attend_window(q, kv, temperature, ctx.row0, rows)

    @staticmethod
    def backward(ctx, g):
        q, kv = ctx.saved_tensors
        dq, dkv = kc.attend_bwd(q, kv, ctx.temperature, kc._rows_contiguous(g),
                                row0=ctx.row0)
        p = q.shape[1]
        return (mesh.all_gather_rows(dq, ctx.group, p),
                mesh.all_reduce_sum(dkv, ctx.group), None, None)


class _PairTP(torch.autograd.Function):
    """K2 on this rank's query rows of both directions, two K3 backward."""

    @staticmethod
    def forward(ctx, f1, f2, temperature, group):
        ctx.row0, rows = mesh.group_window(f1.shape[1], group)
        ctx.temperature, ctx.group = temperature, group
        ctx.save_for_backward(f1, f2)
        return kc.attend_pair_window(f1, f2, temperature, ctx.row0, rows)

    @staticmethod
    def backward(ctx, g1, g2):
        f1, f2 = ctx.saved_tensors
        t, r0, grp, p = ctx.temperature, ctx.row0, ctx.group, f1.shape[1]
        dq1, dkv1 = kc.attend_bwd(f1, f2, t, kc._rows_contiguous(g1), row0=r0)
        dq2, dkv2 = kc.attend_bwd(f2, f1, t, kc._rows_contiguous(g2), row0=r0)
        dq1, dq2 = mesh.all_gather_rows(dq1, grp, p), mesh.all_gather_rows(dq2, grp, p)
        dkv1, dkv2 = mesh.all_reduce_sum(dkv1, grp), mesh.all_reduce_sum(dkv2, grp)
        return dq1 + dkv2, dkv1 + dq2, None, None


def coattention_center(center: torch.Tensor, ref: torch.Tensor,
                       temperature: float = 10.0, tp_shard: bool = False,
                       int8_logits: bool = False) -> torch.Tensor:
    """center, ref: (B, H, W, C) -> attended features for the center (NHWC).
    `int8_logits` takes the logits from int8 codes (`_int8_logits`);
    `tp_shard` splits the query rows over the mesh's model group (see the
    module's notes)."""
    b, h, w, c = center.shape
    k = center.reshape(b, h * w, c)
    v = ref.reshape(b, h * w, c)
    group = mesh.model_group() if tp_shard else None
    if group is not None:
        if not int8_logits:
            out = _CenterTP.apply(k, v, temperature, group)
            return mesh.gather_rows(out, group, h * w).reshape(b, h, w, c)
        row0, rows = mesh.group_window(h * w, group)   # eval only: no gradient
        k = k[:, row0:row0 + rows]
    if int8_logits:
        logits = _int8_logits(k, v, "bpc,bqc->bpq", temperature)
    else:
        logits = torch.einsum("bpc,bqc->bpq", k, v) * temperature
    attn = torch.softmax(logits, dim=2)
    out = torch.einsum("bqc,bpq->bpc", v, attn)
    if group is not None:
        out = mesh.gather_rows(out, group, h * w)
    return out.reshape(b, h, w, c)


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
                     temperature: float = 10.0, tp_shard: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f1, f2: (B, H, W, C) -> (attended_for_f1, attended_for_f2), NHWC: the
    logits T <f1_p, f2_q> softmaxed over q for f1 and over p for f2.
    `tp_shard` splits the query rows of both directions over the mesh's
    model group (see the module's notes)."""
    b, h, w, c = f1.shape
    k = f1.reshape(b, h * w, c)
    v = f2.reshape(b, h * w, c)
    group = mesh.model_group() if tp_shard else None
    if group is not None:
        o1, o2 = _PairTP.apply(k, v, temperature, group)
        p = h * w
        return (mesh.gather_rows(o1, group, p).reshape(b, h, w, c),
                mesh.gather_rows(o2, group, p).reshape(b, h, w, c))
    logits = torch.einsum("bpc,bqc->bpq", k, v) * temperature
    f1_att = torch.einsum("bqc,bpq->bpc", v, torch.softmax(logits, dim=2))
    f2_att = torch.einsum("bpc,bpq->bqc", k, torch.softmax(logits, dim=1))
    return f1_att.reshape(b, h, w, c), f2_att.reshape(b, h, w, c)
