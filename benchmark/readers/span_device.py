"""Device milliseconds per traced step of the kernels, copies and sets
whose host launch lies inside an interval of the program's span
`span:<span>` (reverb_tpu_torch/utils/profiling.py:span).

Launches are matched by time, on any thread: backward's kernels are
launched from autograd's device thread while the main thread, which
holds `train.backward`, waits in `backward()`.  One step runs at a time,
so a launch inside the span's interval is the span's work."""

from bisect import bisect_right


def intervals(trace, span: str) -> tuple:
    """(starts, ends) of the merged intervals of `span:<span>` on every
    thread."""
    name = 'span:' + span
    merged = []
    for s, e in sorted((s, e) for ops in trace.ops.values()
                       for s, e, n, _, _ in ops if n == name):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [m[0] for m in merged], [m[1] for m in merged]


def inside(iv: tuple, t: float) -> bool:
    starts, ends = iv
    i = bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def read(ctx, span: str):
    if ctx.trace is None or not ctx.traced_steps or not ctx.trace.kernels:
        return None
    iv = intervals(ctx.trace, span)
    if not iv[0]:
        return None
    us = 0.0
    for ts, end, _, corr in ctx.trace.kernels:
        launch = ctx.trace.launch.get(corr)
        if launch is not None and inside(iv, launch[1]):
            us += end - ts
    return us * 1e-3 / ctx.traced_steps
