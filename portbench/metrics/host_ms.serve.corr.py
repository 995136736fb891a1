"""Mean host ms of `dcnet.corr` a served tick (K4 off the rings, corr_conv), from its spans."""

from portbench import readers as R
from portbench import spans as S


def read(r):
    return S.stage_ms(r, ("engine.step",), ("dcnet.corr",)) if R.loop_is(r, "serve") else None
