"""The served tick's operations at their peaks over its mean time, %."""

from portbench import readers as R


def read(r):
    return R.mfu(r) if R.loop_is(r, "serve") else None
