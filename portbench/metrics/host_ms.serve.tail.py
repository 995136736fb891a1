"""Mean host ms of `engine.decode`, `engine.cache` and `engine.fuse` a served tick (spans)."""

from portbench import readers as R
from portbench import spans as S


def read(r):
    return (S.stage_ms(r, ("engine.step",), ("engine.decode", "engine.cache", "engine.fuse"))
            if R.loop_is(r, "serve") else None)
