"""Set-up: process start to the first timed unit (host clock), s."""

from portbench import readers as R


def read(r):
    return r.setup_s
