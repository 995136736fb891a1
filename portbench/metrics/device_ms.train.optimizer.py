"""Mean card ms between the CUDA events of `train.optimizer` a training step."""

from portbench import readers as R
from portbench import spans as S


def read(r):
    return (S.stage_ms(r, ("train.step",), ("train.optimizer",), device=True)
            if R.loop_is(r, "train") else None)
