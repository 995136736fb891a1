"""K6 (the int8 convolution, every route and its quantize pass): least time over device time, %."""

from portbench import readers as R


def read(r):
    return R.roofline(r, "k6")
