"""The share of the train step's device time in remat's recompute: the
outermost spans that ran as a recompute in the backward pass (each
layer's model.layer and each loss chunk's model.loss_chunk, flagged
recompute) over step.train."""
from perfbench.lib import spans

UNITS = ("model.layer", "model.loss_chunk")


def read(ctx):
    if ctx.kind != "train":
        return None
    return spans.share(ctx, "step.train", lambda w: w.device_s(
        UNITS, w.outermost_recompute(UNITS)))
