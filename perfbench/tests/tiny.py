"""Cells at a size a CPU test holds: the benchmark's configuration and
two traffic mixes with every width shrunk, in float32, so that the
program (the port's plain versions on the CPU) and the reference agree to
rounding."""
from __future__ import annotations

import copy

from perfbench.lib import cell as cell_mod

RUNS = {
    "falcon-mamba-7b": dict(family="ssm", ssm_type="mamba1", n_layers=2,
                            d_model=64, d_inner=128, ssm_state=8, ssm_conv=4,
                            dt_rank=4, vocab=256, tie_embeddings=True,
                            norm_eps=1e-6, dtype="float32"),
}
TRAFFIC = {
    "train_4k": dict(seq_len=16, warm_steps=3, check_steps=2, trace_steps=2,
                     loss_chunk=8),
    "prefill_32k": dict(lengths={"kind": "fixed", "values": [8, 16, 24, 32]},
                        warm_lengths=[32], check_requests=10**6,
                        trace_requests=4),
}
DATA = {"train_4k": dict(batch=4, check_rows=2)}
#: Limits at this size, where the program runs in float32 and reads
#: rounding alone (about 1e-7; the control reads 3e-4 and more on the
#: training cell's loss).  The prefill check takes every finished
#: request: at this size the control moves the served token of about one
#: request in five (at the tests' seed the first request's among them),
#: by 0.004-0.04 logits.
LIMITS = {"train_4k": {"loss_gap": 1e-5, "first_grad_gap": 1e-3,
                       "change_gap": 1e-3, "first_grad_dist": 1e-3},
          "prefill_32k": {"weights_mismatch": 0, "served_gap": 1e-3}}


def cell(workload: str, limits=None) -> cell_mod.Cell:
    """The benchmark's cell ``workload`` with its files as committed, shrunk
    as RUNS, TRAFFIC and DATA say; ``limits`` replaces its limits (the
    string "tiny": LIMITS)."""
    c = cell_mod.resolve(cell_mod.load_benchmark(), workload)
    c = copy.deepcopy(c)
    c.config["run"] = dict(RUNS[c.config["name"]])
    c.traffic.update(TRAFFIC[c.traffic["name"]])
    c.data.update(DATA.get(c.traffic["name"], {}))
    if limits == "tiny":
        limits = LIMITS[c.traffic["name"]]
    if limits is not None:
        c.data["limits"] = dict(limits)
    return c
