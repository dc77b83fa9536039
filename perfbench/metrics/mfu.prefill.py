"""The prefill step's model FLOPs (2·N of the layers a token, the causal
attention, the head once a request) over the traced window's time, as a
share of 989 TFLOP/s."""
from perfbench.lib import readers


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return readers.mfu(ctx, lambda w: readers.prefill_flops(ctx, w))
