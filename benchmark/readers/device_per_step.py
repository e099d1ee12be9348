"""Device milliseconds per traced step of the kernels launched inside the
host ops matching `under` (and named like `kernel`)."""


def read(ctx, under=None, kernel=None):
    if ctx.trace is None or not ctx.traced_steps:
        return None
    s = ctx.trace.kernel_seconds(kernel, under)
    if s <= 0:
        return None
    return s * 1e3 / ctx.traced_steps
