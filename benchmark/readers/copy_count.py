"""Device copies per traced step whose name starts with `copy` (as
'Memcpy DtoH': the device-to-host reads of `float(t)`, `.item()`,
`.cpu()`, a boolean-mask index) and whose host launch lies inside an
interval of the program's span `span:<within>`, on any thread.  They are
read from the trace itself, so a read the program adds anywhere in the
span is counted."""

from benchmark.readers.span_device import inside, intervals


def copies(trace, copy: str, within: str) -> list:
    """The (ts, end) of each such copy."""
    iv = intervals(trace, within)
    out = []
    for ts, end, name, corr in trace.kernels:
        launch = trace.launch.get(corr)
        if (name.startswith(copy) and launch is not None
                and inside(iv, launch[1])):
            out.append((ts, end))
    return out


def read(ctx, copy: str, within: str):
    if ctx.trace is None or not ctx.traced_steps or not ctx.trace.kernels:
        return None
    n = len(copies(ctx.trace, copy, within))
    return n / ctx.traced_steps if n else None
