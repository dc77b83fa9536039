"""The share of the traced window that lies outside the program's prefill
steps on the device: 1 − the summed device time of the window's
step.prefill spans over the window, in %.  It holds the harness's own
time between requests (tokens, the logits' copy to the host, the sync)."""
from perfbench.lib import spans


def read(ctx):
    if ctx.kind != "prefill":
        return None
    w = spans.window(ctx, "step.prefill")
    steps = None if w is None else w.device_s(["step.prefill"])
    if steps is None:
        return None
    return 100.0 * (1.0 - steps / ctx.trace.window_s)
