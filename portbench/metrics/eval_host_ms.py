"""Mean host time of eval_clip and decode_best's calls (before the read-back), ms."""

from portbench import readers as R


def read(r):
    return R.host_ms(r) if R.loop_is(r, "eval") else None
