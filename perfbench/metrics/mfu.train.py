"""The training step's model FLOPs (PERF.md §2: 6·N + 6·A·H·D·S a token,
no remat) over the traced window's time, as a share of 989 TFLOP/s."""
from perfbench.lib import readers


def read(ctx):
    if ctx.kind != "train":
        return None
    return readers.mfu(ctx, lambda w: readers.train_flops(ctx, w))
