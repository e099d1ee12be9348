"""Median wall time of the window's steps, in ms (each ends in the host
read of its loss)."""

import statistics


def read(ctx):
    if not ctx.step_walls:
        return None
    return statistics.median(ctx.step_walls) * 1e3
