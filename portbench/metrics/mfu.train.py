"""The training step's operations at their peaks over its mean time, %."""

from portbench import readers as R


def read(r):
    return R.mfu(r) if R.loop_is(r, "train") else None
