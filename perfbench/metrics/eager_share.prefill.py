"""The share of the busy device time in eager kernels: neither GEMMs, nor
the hand-written kernels, nor copies (name patterns in lib/readers.py)."""
from perfbench.lib import readers


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return readers.eager_share(ctx)
