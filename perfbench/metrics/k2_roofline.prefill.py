"""The fused Mamba1 scan (K2): the least time the prompts' scans need
(PERF.md §6, one forward a layer a request) over K2's device time."""
from perfbench.lib import readers


def read(ctx):
    if ctx.kind != "prefill":
        return None
    t = ctx.trace.time_of(readers.named(*readers.K2_FWD))
    return readers.share(readers.k2_bound(ctx, train=False), t)
