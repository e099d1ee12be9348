"""Share of an unprofiled step in which no operation runs on the device:
1 − (the union of kernel, copy and set intervals in the timing window, a
step) / (the median wall time of the unprofiled steps).  The timing
window's own idle share (1 − busy_s / window_s of the result's `device`)
also holds the profiler's host cost on every op; this one does not."""

import statistics


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps or not ctx.step_walls:
        return None
    busy = ctx.trace.busy_s() / ctx.traced_steps
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / statistics.median(ctx.step_walls))
