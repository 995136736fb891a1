"""Clips evaluated, boxes read back, over the whole window, per second."""

from portbench import readers as R


def read(r):
    return R.rate(r) if R.loop_is(r, "eval") else None
