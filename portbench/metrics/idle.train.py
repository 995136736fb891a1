"""The device's idle share of a training step, %."""

from portbench import readers as R


def read(r):
    return R.idle(r) if R.loop_is(r, "train") else None
