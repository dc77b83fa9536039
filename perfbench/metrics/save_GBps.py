"""The scda save of the served weights in set-up: file bytes over the
save's wall time (repro_torch.checkpoint.save, timed by the harness)."""


def read(ctx):
    s = ctx.spans
    if not s.get("save_s"):
        return None
    return s["file_bytes"] / s["save_s"] / 1e9
