"""K4 (co-attention of each center to every reference off the ring): least time over device time, %."""

from portbench import readers as R


def read(r):
    return R.roofline(r, "k4")
