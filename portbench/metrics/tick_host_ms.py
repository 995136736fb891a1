"""Mean host time of GroundingEngine.step's call (dispatch, before the read-back), ms."""

from portbench import readers as R


def read(r):
    return R.host_ms(r) if R.loop_is(r, "serve") else None
