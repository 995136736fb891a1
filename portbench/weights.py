"""The benchmark's weights: drawn from the seed on the device, in a few
large calls, for the parameter list of `reference.model.param_spec`. The
program and the reference get the same numbers; neither makes its own.

Kinds: `fan_in` normal kernels scaled by 1/sqrt(fan-in), `unit_in`
N(0, 1) kernels of a layer whose input vectors have unit norm (so that
its outputs are O(1) as the others'), `bias` 0.01 N,
BatchNorm affine near identity and running statistics near (0, 1),
`bn_bias_sparse` the same shifted by -0.5,
`embedding` N(0, 1), LayerNorm near identity, `lstm` U(+-1/sqrt(H)), and
the BatchNorm step counters at zero.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from portbench.reference.model import Param

_NORMAL = {"fan_in", "unit_in", "bias", "bn_weight", "bn_bias", "bn_bias_sparse", "bn_mean", "embedding", "ln_weight",
           "ln_bias"}
_UNIFORM = {"bn_var", "lstm"}


def make_weights(spec: Sequence[Param], seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> fp32 tensor (int64 for the counters) on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_norm = sum(math.prod(p.shape) for p in spec if p.kind in _NORMAL)
    n_unif = sum(math.prod(p.shape) for p in spec if p.kind in _UNIFORM)
    normal = torch.randn(n_norm, generator=gen, device=device)
    uniform = torch.rand(n_unif, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    i_n = i_u = 0
    for p in spec:
        n = math.prod(p.shape)
        if p.kind in _NORMAL:
            v, i_n = normal[i_n:i_n + n].view(p.shape), i_n + n
        elif p.kind in _UNIFORM:
            v, i_u = uniform[i_u:i_u + n].view(p.shape), i_u + n
        if p.kind == "fan_in":
            v = v * (1.0 / math.sqrt(math.prod(p.shape[1:])))
        elif p.kind == "bias":
            v = 0.01 * v
        elif p.kind in ("bn_weight", "ln_weight"):
            v = 1.0 + 0.1 * v
        elif p.kind in ("bn_bias", "bn_mean", "ln_bias"):
            v = 0.1 * v
        elif p.kind == "bn_bias_sparse":
            v = 0.1 * v - 0.5
        elif p.kind == "bn_var":
            v = 0.5 + v
        elif p.kind == "lstm":
            hidden = p.shape[0] // 4
            v = (2.0 * v - 1.0) / math.sqrt(hidden)
        elif p.kind == "count":
            v = torch.zeros((), dtype=torch.int64, device=device)
        elif p.kind not in ("embedding", "unit_in"):
            raise ValueError(f"unknown kind {p.kind!r} of {p.name}")
        out[p.name] = v.contiguous() if v.dtype == torch.int64 else v.clone()
    return out
