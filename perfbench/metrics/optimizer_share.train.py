"""The share of the train step's device time in AdamW's update: the
program's span step.optimizer over step.train."""
from perfbench.lib import spans


def read(ctx):
    if ctx.kind != "train":
        return None
    return spans.share(ctx, "step.train",
                       lambda w: w.device_s(["step.optimizer"]))
