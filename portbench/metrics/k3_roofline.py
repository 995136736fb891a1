"""K3 (co-attention backward, dq and dkv grids): least time over device time, %."""

from portbench import readers as R


def read(r):
    return R.roofline(r, "k3")
