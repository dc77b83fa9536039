"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W limit): the yardstick every share is taken against."""

BF16_FLOPS = 989e12
F32_FLOPS = 67e12          # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
#: Exponentials a second: 16 a clock on each SM's special function units,
#: 132 SMs, 1.98 GHz boost clock.
EXP_PER_S = 132 * 16 * 1.98e9


def bound_s(nbytes: float, flops: float, peak_flops: float,
            exps: float = 0.0) -> float:
    """The least time for a piece of work: its bytes at the memory rate,
    or its operations, the larger of its FLOPs at ``peak_flops`` and its
    exponentials at the SFU rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops,
               exps / EXP_PER_S)
