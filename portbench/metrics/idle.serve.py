"""The device's idle share of a served tick, %."""

from portbench import readers as R


def read(r):
    return R.idle(r) if R.loop_is(r, "serve") else None
