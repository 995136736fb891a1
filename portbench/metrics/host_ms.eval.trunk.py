"""Mean host ms of `dcnet.trunk` an eval call, from the program's spans."""

from portbench import readers as R
from portbench import spans as S


def read(r):
    return (S.stage_ms(r, ("dcnet.eval_clip", "decode.best"), ("dcnet.trunk",))
            if R.loop_is(r, "eval") else None)
