"""The fused Mamba1 scan (K2) and its backward: the least time the
training steps' scans need (PERF.md §6's bounds, one forward with states
and one backward a layer a step) over the device time of K2's kernels,
the remat recompute included."""
from perfbench.lib import readers


def read(ctx):
    if ctx.kind != "train":
        return None
    t = ctx.trace.time_of(readers.named(*(readers.K2_FWD + readers.K2_BWD)))
    return readers.share(readers.k2_bound(ctx, train=True), t)
