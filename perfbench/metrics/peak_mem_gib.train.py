"""The device memory allocated at the peak of the traced window, GiB."""


def read(ctx):
    if ctx.kind != "train" or not ctx.window_peak:
        return None
    return ctx.window_peak / 2**30
