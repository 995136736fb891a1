"""Hand-written Hopper kernels and their plain PyTorch versions.

`LAUNCHES` counts, per kernel, the launches its wrapper made: a wrapper adds
one where it launches its kernel and nowhere else, so a run can show that
the main path went through the kernels (`chip_smoke.py` zeroes it before
driving the path and reads it after). `coattn_attend` counts K1,
`coattn_pair` K2 (one launch computes both directions) and
`coattn_attend_bwd` K3 (one count per call, whose two grids form one
backward) and `coattn_ring` K4 (one launch covers every reference of a
ring at one scale).
"""

from typing import Dict

LAUNCHES: Dict[str, int] = {"coattn_attend": 0, "coattn_pair": 0,
                            "coattn_attend_bwd": 0, "coattn_ring": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
