"""Mean host ms of `dcnet.extract` a served tick (backbone, mapping), from the program's spans."""

from portbench import readers as R
from portbench import spans as S


def read(r):
    return S.stage_ms(r, ("engine.step",), ("dcnet.extract",)) if R.loop_is(r, "serve") else None
