"""The share of the prefill step's device time in the Mamba1 block's
eager parts: the program's spans ssm.conv (causal conv and SiLU), ssm.dt
(dt_proj, bias and softplus) and ssm.gate (D·x and the SiLU gate) over
step.prefill."""
from perfbench.lib import spans


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return spans.share(ctx, "step.prefill", lambda w: w.device_s(
        ["ssm.conv", "ssm.dt", "ssm.gate"]))
