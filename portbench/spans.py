"""What the readers of the program's own spans share.

The program records a span around each stage of its calls, on the host
clock, into a ring (`dcnet_tpu_torch.utils.profiling`: `root_calls`,
`stage_ms`, a root span's `counts`). The harness runs the warm-up, then the
timed window, then (`--trace 1`) the profiled units, so the window's calls
are the last `r.units` root calls recorded with no profiler running.

A reader returns None where the program records no spans, where there are
fewer such calls than the window's units, or where they do not line up
with the window one for one: each unit's root spans (in eval,
`dcnet.eval_clip` and `decode.best`) no longer than its `host_s`, and their
mean within 2% of the mean `host_s`. A misread window never turns into a
number.
"""

from __future__ import annotations

import importlib
from typing import Optional, Sequence

ALIGN = 0.02        # the largest gap between the means, a share of host_s's
SLACK_S = 1e-6      # two readings of one clock, one of them in float seconds


def _profiling():
    """The program's profiling module, where it records spans."""
    try:
        mod = importlib.import_module("dcnet_tpu_torch.utils.profiling")
    except ImportError:
        return None
    return mod if hasattr(mod, "root_calls") else None


def window(r, roots: Sequence[str]):
    """The profiling module, where the last `r.units` unprofiled calls of
    each root line up with the window's units; else None."""
    prof = _profiling()
    if prof is None or r.units < 1:
        return None
    calls = [prof.root_calls(name, r.units) for name in roots]
    if any(len(c) < r.units for c in calls):
        return None
    spans_s = [sum(c[i].host_ms for c in calls) / 1e3 for i in range(r.units)]
    if any(s > h + SLACK_S for s, h in zip(spans_s, r.host_s)):
        return None
    mean_spans, mean_host = sum(spans_s) / r.units, sum(r.host_s) / r.units
    if abs(mean_spans - mean_host) > ALIGN * mean_host:
        return None
    return prof


def stage_ms(r, roots: Sequence[str], stages: Sequence[str],
             device: bool = False) -> Optional[float]:
    """The summed mean ms a unit of the `stages` spans under the first of
    `roots` over the window (host ms, or the card's between the spans'
    CUDA events)."""
    prof = window(r, roots)
    if prof is None:
        return None
    means = [prof.stage_ms(roots[0], s, r.units, device=device) for s in stages]
    return None if any(m is None for m in means) else sum(means)


def count(r, root: str, key: str) -> Optional[float]:
    """The mean change of the program's counter `key` a `root` call over
    the window."""
    prof = window(r, (root,))
    if prof is None:
        return None
    calls = prof.root_calls(root, r.units)
    return sum(c.counts.get(key, 0) for c in calls) / len(calls)
