"""K1 (co-attention of a center to one reference, kernels.coattn): least time over device time, %."""

from portbench import readers as R


def read(r):
    return R.roofline(r, "k1")
