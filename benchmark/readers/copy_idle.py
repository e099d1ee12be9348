"""Device idle milliseconds per traced step that open when one of
`copy_count`'s copies ends: the gaps between the timing window's busy
intervals whose busy interval ends with such a copy.  A device-to-host
read drains the stream, so the card idles from the copy's end until the
host, done with the value, launches again."""

from benchmark.readers.copy_count import copies


def read(ctx, copy: str, within: str):
    if ctx.trace is None or not ctx.traced_steps or not ctx.trace.kernels:
        return None
    ends = {end for _, end in copies(ctx.trace, copy, within)}
    if not ends:
        return None
    busy = ctx.trace.busy_intervals()
    us = sum(nxt[0] - cur[1] for cur, nxt in zip(busy, busy[1:])
             if cur[1] in ends)
    return us * 1e-3 / ctx.traced_steps
