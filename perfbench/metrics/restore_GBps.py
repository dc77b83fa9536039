"""The scda restore of the served weights onto the card in set-up: file
bytes over the wall time of repro_torch.serve.load_weights."""


def read(ctx):
    s = ctx.spans
    if not s.get("restore_s"):
        return None
    return s["file_bytes"] / s["restore_s"] / 1e9
