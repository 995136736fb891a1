"""The device's idle share of an eval call, %."""

from portbench import readers as R


def read(r):
    return R.idle(r) if R.loop_is(r, "eval") else None
