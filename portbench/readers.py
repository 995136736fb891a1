"""What the metric readers share: rates and tails over the whole window,
shares of a peak or a roofline, and the device's idle share. A reader
that finds nothing to read returns None; a share is never made up."""

from __future__ import annotations

from typing import Optional

import numpy as np

from portbench.work.dcnet import least_unit_seconds


def loop_is(r, name: str) -> bool:
    return r.traffic["loop"] == name


def rate(r) -> float:
    """Items completed over the whole window, per second."""
    return r.units * r.items / r.window_s


def p95_ms(r) -> float:
    """The 95th percentile of every unit's time in the window (numpy's
    linear interpolation), in ms."""
    return float(np.percentile(np.asarray(r.unit_s), 95)) * 1e3


def host_ms(r) -> float:
    """The mean host time of the program's call, in ms."""
    return float(np.mean(r.host_s)) * 1e3


def mfu(r) -> float:
    """The unit's operations at their precisions' peaks over its mean
    measured time in the window, in %."""
    return 100.0 * least_unit_seconds(r.work) / (r.window_s / r.units)


def roofline(r, kernel: str) -> Optional[float]:
    """The kernel's least time per unit (from the cell's shapes) over its
    device time per unit in the traced sub-window, in %."""
    if r.trace is None or kernel not in r.work["kernels"]:
        return None
    spent = r.trace["kernel_s"].get(kernel, 0.0)
    if spent <= 0.0:
        return None
    return 100.0 * r.work["kernels"][kernel] / (spent / r.trace["units"])


def idle(r) -> Optional[float]:
    """1 - the device's busy time per unit (traced sub-window) over the wall
    time per unit (the unprofiled window), in %."""
    if r.trace is None or r.trace["busy_s"] <= 0.0:
        return None
    busy = r.trace["busy_s"] / r.trace["units"]
    return 100.0 * (1.0 - busy / (r.window_s / r.units))
