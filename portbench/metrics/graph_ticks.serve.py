"""The share of a served tick's window calls that replayed a CUDA graph (`graph_replays` over
the last `units` unprofiled `engine.step` roots), %. A count, so read without the host-time
alignment that the span times need. Where the program counts no `graph_replays`, nothing."""

from portbench import readers as R
from portbench import spans as S


def read(r):
    if not R.loop_is(r, "serve") or r.units < 1:
        return None
    prof = S._profiling()
    calls = [] if prof is None else prof.root_calls("engine.step", r.units)
    if len(calls) < r.units or any("graph_replays" not in c.counts for c in calls):
        return None
    return 100.0 * sum(c.counts["graph_replays"] for c in calls) / len(calls)
