"""Mean host ms of `dcnet.corr` an eval call (K1 per reference, corr_conv), from its spans."""

from portbench import readers as R
from portbench import spans as S


def read(r):
    return (S.stage_ms(r, ("dcnet.eval_clip", "decode.best"), ("dcnet.corr",))
            if R.loop_is(r, "eval") else None)
