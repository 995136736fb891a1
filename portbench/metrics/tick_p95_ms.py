"""The 95th percentile over all ticks of the window: frames handed over to boxes on the host, ms."""

from portbench import readers as R


def read(r):
    return R.p95_ms(r) if R.loop_is(r, "serve") else None
