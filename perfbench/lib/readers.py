"""What the per-layer metrics' readers share: kernel names as the
profiler shows them, and the work of a traced window."""
from __future__ import annotations

import re

from perfbench.counts import kernels as kc
from perfbench.counts import model as mc
from perfbench.counts import peaks

#: The port's hand-written kernels by the names the profiler gives them
#: (K1's too, so that no cell counts them as eager work).
K2_FWD = ("ssm_scan_fused_kernel",)
K2_BWD = ("ssm_scan_bwd_kernel", "ssm_scan_bwd_reduce_kernel")
K1_FWD = ("flash_prefill_kernel", "flash_prefill_f32_kernel")
K1_BWD = ("flash_bwd_preprocess_kernel", "flash_bwd_dkdv_kernel",
          "flash_bwd_dq_kernel", "flash_bwd_dkdv_wide_kernel",
          "flash_bwd_dq_wide_kernel", "flash_bwd_dkdv_fma_kernel",
          "flash_bwd_dq_fma_kernel")


def named(*names):
    """A matcher of kernel names holding any of ``names`` as a word."""
    pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    return lambda name: bool(pat.search(name))


def share(bound_s: float, time_s: float):
    """bound / time in %, or None where no such kernel ran."""
    return None if time_s <= 0 else 100.0 * bound_s / time_s


def mfu(ctx, flops_of) -> float:
    flops = sum(flops_of(w) for w in ctx.work)
    return 100.0 * flops / ctx.trace.window_s / peaks.BF16_FLOPS


def train_flops(ctx, w) -> float:
    return mc.train_flops_per_token(ctx.cell.run, w["S"]) * w["B"] * w["S"]


def prefill_flops(ctx, w) -> float:
    return w["B"] * mc.prefill_flops(ctx.cell.run, w["S"])


def k2_bound(ctx, train: bool) -> float:
    """The Mamba1 scans the traced work needs: one forward a layer (with
    the states its backward reads, when training) and one backward."""
    r = ctx.cell.run
    d, N, L = r["d_inner"], r["ssm_state"], r["n_layers"]
    total = 0.0
    for w in ctx.work:
        total += L * kc.k2_fused_s(w["B"], w["S"], d, N, states=train)
        if train:
            total += L * kc.k2_bwd_s(w["B"], w["S"], d, N)
    return total


#: Device rows that are not eager work: GEMM libraries' kernels, the
#: hand-written kernels, copies and sets.
GEMM = re.compile(r"gemm|nvjet|cutlass|xmma|splitKreduce|cublas", re.I)
COPIES = re.compile(r"^Memcpy|^Memset")
HAND_WRITTEN = named(*(K2_FWD + K2_BWD + K1_FWD + K1_BWD))


def eager_share(ctx) -> float:
    """Device time of kernels that are neither GEMMs, nor the hand-written
    kernels, nor copies, over the busy time, in %."""
    t = ctx.trace.time_of(lambda n: not (GEMM.search(n) or COPIES.search(n)
                                         or HAND_WRITTEN(n)))
    return 100.0 * t / ctx.trace.busy_s
