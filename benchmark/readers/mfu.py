"""Model FLOPs of the window's work (benchmark/counts.py, from shapes)
over the window's wall time, as a share of the configuration's dense
peak."""


def read(ctx):
    if not getattr(ctx, 'flops', 0) or not ctx.window_wall:
        return None
    return 100.0 * ctx.flops / ctx.window_wall / ctx.peak_flops
