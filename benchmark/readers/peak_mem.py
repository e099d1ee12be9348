"""torch.cuda.max_memory_allocated() over the window, in GiB."""


def read(ctx):
    b = getattr(ctx, 'window_peak_bytes', 0)
    return b / 2 ** 30 if b else None
