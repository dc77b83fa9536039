"""Parameter shapes, parameter counts and model FLOPs of a configuration,
from the numbers in its file under ``configs/`` (its ``run`` section).

A frozen copy of the arithmetic of ``PERF.md`` §2 (``chip_smoke.py``'s
``train_flops``) and of the port's parameter layout: the yardstick does
not move when the program changes.  Leaves are named as the port's
nested parameter dict, dots between the levels, and layer leaves are
stacked on a leading axis of ``n_layers``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

#: (shape, init): init is ("normal", std), ("uniform", bound), ("zeros",),
#: ("ones",), ("log_arange", N) (log 1..N along the last dim) or ("dt_bias",
#: lo, hi, floor) (softplus⁻¹ of dt log-uniform over [lo, hi]).  The
#: port's distributions, but for the published Mamba initialization of dt
#: (mamba_ssm's dt_init: dt_proj uniform in ±dt_rank^-0.5, dt in
#: [1e-3, 1e-1]).
Leaf = Tuple[Tuple[int, ...], tuple]
DT_BIAS = ("dt_bias", 1e-3, 1e-1, 1e-4)


def _normal(fan_in: int, scale=None):
    return ("normal", scale if scale is not None else 1.0 / math.sqrt(fan_in))


def leaf_specs(run: Dict) -> Dict[str, Leaf]:
    """Every parameter leaf of the model, in the order the harness draws
    them: name -> (shape, init)."""
    d, V, L = run["d_model"], run["vocab"], run["n_layers"]
    di, N, K = run["d_inner"], run["ssm_state"], run["ssm_conv"]
    out: Dict[str, Leaf] = {
        "embed": ((V, d), ("normal", 0.02)),
        "final_norm": ((d,), ("zeros",)),
        "layers.ln1": ((L, d), ("zeros",)),
    }
    if not run.get("tie_embeddings", True):
        raise ValueError("the counts know tied embeddings only")
    if run["ssm_type"] != "mamba1":
        raise ValueError("the counts know Mamba1 layers only")
    s = "layers.ssm."
    R = run["dt_rank"]
    out.update({
        s + "in_x": ((L, d, di), _normal(d)),
        s + "in_z": ((L, d, di), _normal(d)),
        s + "conv_w": ((L, di, K), _normal(K)),
        s + "conv_b": ((L, di), ("zeros",)),
        s + "x_proj": ((L, di, R + 2 * N), _normal(di)),
        s + "dt_proj": ((L, R, di), ("uniform", R ** -0.5)),
        s + "dt_bias": ((L, di), DT_BIAS),
        s + "A_log": ((L, di, N), ("log_arange", N)),
        s + "D": ((L, di), ("ones",)),
        s + "out_proj": ((L, di, d), _normal(di)),
    })
    return out


def numel(shape) -> int:
    return math.prod(shape)


def param_count(run: Dict) -> int:
    """Every parameter of the model."""
    return sum(numel(shape) for shape, _ in leaf_specs(run).values())


def layer_params(run: Dict) -> int:
    """The parameters a prompt token meets in the layers: all but the
    embedding and the final norm."""
    return param_count(run) - run["vocab"] * run["d_model"] - run["d_model"]


def train_flops_per_token(run: Dict, S: int) -> float:
    """PERF.md §2: 6·N a token (forward and backward, no remat; an
    attention-free model has no term in S)."""
    return 6 * param_count(run)


def prefill_flops(run: Dict, S: int) -> float:
    """One prompt of S tokens: 2·N of the layers a token, and the head once
    (the last-token logits)."""
    return 2 * layer_params(run) * S + 2 * run["d_model"] * run["vocab"]
