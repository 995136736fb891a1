"""Hand-written Hopper kernels and their plain PyTorch versions.

`LAUNCHES` counts, per kernel, the launches its wrapper made: a wrapper adds
one where it launches its kernel and nowhere else, so a run can show that
the main path went through the kernels (`chip_smoke.py` zeroes it before
driving the path and reads it after).
"""

from typing import Dict

LAUNCHES: Dict[str, int] = {"coattn_attend": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
