"""Hand-written Hopper kernels and their plain PyTorch versions.

`LAUNCHES` counts, per kernel, the launches its wrapper made: a wrapper adds
one where it launches its kernel and nowhere else, so a run can show that
the main path went through the kernels (`chip_smoke.py` zeroes it before
driving the path and reads it after). `coattn_attend` counts K1,
`coattn_pair` K2 (one launch computes both directions) and
`coattn_attend_bwd` K3 (one count per call, whose two grids form one
backward), `coattn_ring` K4 (one launch covers every reference of a
ring at one scale), `loc_gram` K5 (no path runs it), K6 (the int8
convolution, one count a convolution) under the key of the route that
launched it (`CONV_S8_KEYS`, by `kernels.conv_s8.conv_plan`'s route names:
`conv_s8` the TMA route, `conv_s8_halo` the halo route, `conv_s8_gather`
the gather route; `conv_s8_launches` sums them), `conv_s8_quant` K6's
quantize pass (one count a pass: a float x on the TMA route, and each
operand whose channels it pads) and `bn_act` K7 (the eval-mode epilogue of
a float convolution: BatchNorm, activation and shortcut add, one count a
launch).

Importing the package registers the kernels that a serving tick reaches
as operators (`torch.library.custom_op`, namespace `dcnet`):
`dcnet::attend` (K1), `dcnet::ring` (K4), `dcnet::conv_s8` (K6, its route
picked inside), `dcnet::conv_s8_quant` (K6's quantize pass) and
`dcnet::bn_act` (K7). A program
saved by `torch.export` that calls them loads once this package is
imported. Each counts its launches in its real implementation only.
"""

from typing import Dict

LAUNCHES: Dict[str, int] = {"coattn_attend": 0, "coattn_pair": 0,
                            "coattn_attend_bwd": 0, "coattn_ring": 0,
                            "loc_gram": 0, "conv_s8": 0, "conv_s8_halo": 0,
                            "conv_s8_gather": 0, "conv_s8_quant": 0, "bn_act": 0}
CONV_S8_KEYS: Dict[str, str] = {"tma": "conv_s8", "halo": "conv_s8_halo",
                                "gather": "conv_s8_gather"}


def conv_s8_launches(counts: Dict[str, int] = LAUNCHES) -> int:
    """K6's convolutions on every route in `counts` (LAUNCHES, or the
    difference of two of its copies)."""
    return sum(counts[key] for key in CONV_S8_KEYS.values())


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the operator library (imported last: the modules read LAUNCHES)
from dcnet_tpu_torch.kernels import bn_act, coattn, conv_s8  # noqa: E402,F401
