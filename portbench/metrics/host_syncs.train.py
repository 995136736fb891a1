"""Mean waits of the host on the card a training step (`host_syncs` over `train.step`)."""

from portbench import readers as R
from portbench import spans as S


def read(r):
    return S.count(r, "train.step", "host_syncs") if R.loop_is(r, "train") else None
