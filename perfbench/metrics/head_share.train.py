"""The share of the train step's device time in the loss head: the
program's spans model.loss_head (the chunked head's forward) and
model.loss_head.bwd (its backward, each chunk's recompute included) over
step.train."""
from perfbench.lib import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    return spans.share(ctx, "step.train", lambda w: w.device_s(
        ["model.loss_head", "model.loss_head.bwd"]))
