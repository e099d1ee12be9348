"""A kernel's share of its roofline in the traced window: Σ over its calls
of max(operations / peak, bytes / 3.35 TB/s), over the device time of its
launches.

params: `kernel` (regex on device kernel names) and/or `under` (regex on
the host op its launches sit in) select the device time in the timing
window; the calls are the host op `shapes_op`'s input shapes in the shapes
window, which runs the same batches; `count` names the count function in
benchmark/counts.py; `counter` (`module:ATTRIBUTE`) is the program's
launch counter of the kernel.  A kernel that the counter saw no launch of
is off the path and gives no reading; one that it saw launched but the
trace does not show, or as many times as the shapes, is a fault of the
measurement and raises."""

from benchmark import core, counts


def read(ctx, count: str, counter: str, kernel=None, under=None,
         shapes_op=None):
    if ctx.trace is None or not ctx.launches.get(counter):
        return None
    launches = ctx.launches[counter]
    dev = ctx.trace.kernel_seconds(kernel, under)
    if dev <= 0:
        raise core.BenchError(
            f'{counter} counted {launches} launches in the timing window '
            f'but its trace has no kernel matching {kernel!r} under '
            f'{under!r} among its {len(ctx.trace.kernels)} device events')
    fn = getattr(counts, count)
    work = [fn(d, t) for d, t in ctx.shapes_trace.op_shapes(shapes_op)]
    if len(work) != launches:
        raise core.BenchError(
            f'{counter} counted {launches} launches in the timing window '
            f'but the shapes window recorded {len(work)} {shapes_op} calls')
    bound = counts.bound_seconds(work, ctx.peak_flops, core.PEAK_BYTES_S)
    return 100.0 * bound / dev
