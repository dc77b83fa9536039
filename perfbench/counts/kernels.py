"""The least time of the hand-written kernels' work, from the shapes of a
call: a frozen copy of the bound formulas of ``PERF.md`` §6 (the table of
kernels; ``chip_smoke.py``'s ``bound`` at each kernel's check).

Bytes count each input read once and each output written once; the
fused K2 and its backward are bound by their exponentials or their
bytes, as §6 states.
"""
from __future__ import annotations

from perfbench.counts import peaks

#: The fused K2 stores its state every this many steps for its backward.
STATE_EVERY = 16


def _k2_sizes(B, S, d, N):
    elems = B * S * d * N
    inputs = 2 * 2 * B * S * d + 2 * 2 * B * S * N + 4 * d * N  # x dt B C A
    states = 4 * B * -(-S // STATE_EVERY) * d * N
    return elems, inputs, states


def k2_fused_s(B: int, S: int, d: int, N: int, states: bool) -> float:
    """The fused Mamba1 scan forward (bf16 x, dt, B, C; f32 A and y), with
    or without writing the states its backward reads."""
    elems, inputs, st = _k2_sizes(B, S, d, N)
    nbytes = inputs + 4 * B * S * d + (st if states else 0)
    return peaks.bound_s(nbytes, 7 * elems, peaks.F32_FLOPS, exps=elems)


def k2_bwd_s(B: int, S: int, d: int, N: int) -> float:
    """K2's backward: reads the inputs, dy (f32) and the states, writes
    dx, ddt, dB, dC and dA."""
    elems, inputs, st = _k2_sizes(B, S, d, N)
    nbytes = inputs + 4 * B * S * d + st + inputs
    return peaks.bound_s(nbytes, 20 * elems, peaks.F32_FLOPS, exps=elems)

