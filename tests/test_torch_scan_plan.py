"""The work split of K2's fused forward and backward, as the plans describe
it (``fused_plan``, ``bwd_plan``, and ``plan_fused`` / ``plan_bwd`` on
tensors).

A block of the fused forward owns ``threads`` channels, one lane each; a
backward block walks ``passes`` groups of ``threads / L`` channels, L
lanes each, a lane N / L states.  Held here on the CPU: every (b, d, n) is
owned by exactly one lane, a block's shared memory fits the card, the
backward's partial sums of dB, dC and dA (indexed as the kernel writes
them) hold each element once and are summed over every block by the
reductions, the backward's lanes are the instantiations its source has,
and the main path's shapes (falcon-mamba's B and C are slices of its
x_proj output) take the TMA load path while the unaligned test cases take
the threads' path.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from test_torch_gpu import FUSED_CASES  # noqa: E402

FALCON_D, FALCON_N, FALCON_ROW = 8192, 16, 288   # d_inner, state, x_proj


def _owners(plan, d, N, threads):
    """How many lanes own each (c, n) of a batch row (every row alike)."""
    per_pass = threads // plan.lanes
    assert plan.channels == per_pass * plan.passes
    bx, p, tid, i = np.ix_(np.arange(plan.grid[0]), np.arange(plan.passes),
                           np.arange(threads), np.arange(plan.lane_states))
    shape = (plan.grid[0], plan.passes, threads, plan.lane_states)
    c = np.broadcast_to(bx * plan.channels + p * per_pass
                        + tid // plan.lanes, shape)
    n = np.broadcast_to((tid % plan.lanes) * plan.lane_states + i, shape)
    live = (c < d) & (n < N)
    count = np.zeros((d, N), dtype=np.int64)
    np.add.at(count, (c[live], n[live]), 1)
    return count


def part_bc_index(q, slab, b, t, n, nslab, B, S, N):
    """Where block (slab, b) of the backward writes its sum of dB's (q = 0)
    or dC's (q = 1) terms at step t and state n (``ssm_scan_bwd.cu``:
    ``((((q * gridDim.x + blockIdx.x) * B + b) * S + t) * N + n``)."""
    return (((q * nslab + slab) * B + b) * S + t) * N + n


def reduce_reads(base, ns, stride, i):
    """What ``ssm_scan_bwd_reduce_kernel`` sums into out[i]: in[base + k *
    stride + i] for k < ns, in order."""
    return base + np.arange(ns) * stride + i


def _hold_partials(plan, B, S, d, N, threads, index=part_bc_index):
    """The backward's partials as the kernel indexes them: every entry of
    part_bc written by exactly one block, dB and dC (B, S, N) each summed
    over all ``plan.grid[0]`` blocks along d; every entry of part_a written
    by the lane that owns its (c, n), dA summed over the batch."""
    part_bc, part_a = plan.partials
    assert part_bc == (2, plan.grid[0], B, S, N) and part_a == (B, d, N)
    nslab = plan.grid[0]
    q, slab, b, t, n = np.ix_(range(2), range(nslab), range(B), range(S),
                              range(N))
    at = index(q, slab, b, t, n, nslab, B, S, N)
    at = np.broadcast_to(at, (2, nslab, B, S, N))
    hits = np.bincount(at.ravel(), minlength=int(np.prod(part_bc)))
    assert hits.size == np.prod(part_bc) and (hits == 1).all()
    bsn = B * S * N
    for qq, base in ((0, 0), (1, nslab * bsn)):   # dB, then dC
        for i in range(bsn):
            bb, tt, nn = i // (S * N), i // N % S, i % N
            got = reduce_reads(base, nslab, bsn, i)
            assert (got == at[qq, :, bb, tt, nn]).all()
    # dA: lane (c, n) of batch row b writes part_a[b, c, n]; the reduction
    # sums B rows d N apart
    owners = _owners(plan, d, N, threads)
    assert (owners == 1).all()
    for i in range(d * N):
        assert (reduce_reads(0, B, d * N, i)
                == np.arange(B) * d * N + i).all()


def _hold(plan, B, S, d, N, threads, bwd):
    P = 1 << max(0, N - 1).bit_length()
    assert plan.lanes == (ss.BWD_LANES[P] if bwd else 1)
    assert plan.lanes * plan.lane_states == P
    assert plan.grid == (-(-d // plan.channels), B)
    assert (_owners(plan, d, N, threads) == 1).all()
    assert 0 < plan.smem_bytes <= ss.SMEM_LIMIT
    if not bwd:
        assert plan.passes == 1 and plan.partials == ()
        return
    assert plan.channels <= ss.BWD_MAX_CHANNELS
    _hold_partials(plan, B, S, d, N, threads)


SHAPES = [(B, S, d, N) for B, S, d, N in
          ((1, 1, 1, 1), (2, 37, 5, 3), (3, 70, 33, 8), (2, 20, 3, 32),
           (1, 64, 300, 16), (2, 9, 100, 16), (16, 5, 4096, 16),
           (1, 20, 96, 32), (2, 33, 24, 2), (4, 7, 1000, 5))]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,S,d,N", SHAPES)
def test_fused_plan_owns_every_state_once(B, S, d, N, itemsize):
    plan = ss.fused_plan(B, S, d, N, itemsize, True)
    _hold(plan, B, S, d, N, ss.FWD_THREADS, bwd=False)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,S,d,N", SHAPES)
def test_bwd_plan_owns_every_state_once(B, S, d, N, itemsize):
    plan = ss.bwd_plan(B, S, d, N, itemsize, True)
    _hold(plan, B, S, d, N, ss.BWD_THREADS, bwd=True)


def test_partials_check_catches_a_wrong_index():
    """The partials' check fails on an index that is one to one but puts a
    slab's sums where the reduction does not read them for that output."""
    def swapped(q, slab, b, t, n, nslab, B, S, N):
        return (((slab * 2 + q) * B + b) * S + t) * N + n
    plan = ss.bwd_plan(2, 5, 300, 3, 4, True)
    assert plan.grid[0] > 1
    _hold_partials(plan, 2, 5, 300, 3, ss.BWD_THREADS)
    with pytest.raises(AssertionError):
        _hold_partials(plan, 2, 5, 300, 3, ss.BWD_THREADS, index=swapped)


def test_bwd_lanes_are_the_instantiations_of_the_source():
    """The (L, NL) pairs the plan picks by P are the backward kernels the
    source instantiates, one a power of two."""
    src = (Path(ss.__file__).parent / "csrc" / ss.SOURCE_BWD).read_text()
    made = {(int(L), int(NL)) for L, NL in re.findall(
        r"ssm_scan_bwd_kernel<Tin, (\d+), (\d+)>", src)}
    assert made == {(L, P // L) for P, L in ss.BWD_LANES.items()}
    assert sorted(ss.BWD_LANES) == [1 << k for k in range(6)]
    for N in range(1, ss.MAX_STATE + 1):
        P = 1 << max(0, N - 1).bit_length()
        assert ss.bwd_plan(1, 1, 64, N, 2, True).lanes == ss.BWD_LANES[P]


def test_shared_memory_fits_at_every_state_size():
    for N in range(1, ss.MAX_STATE + 1):
        for itemsize in (2, 4):
            assert ss.fused_plan(1, 1, 8192, N, itemsize,
                                 True).smem_bytes <= ss.SMEM_LIMIT
            # the most passes a block may walk
            plan = ss.bwd_plan(64, 1, 1 << 20, N, itemsize, True)
            assert plan.smem_bytes <= ss.SMEM_LIMIT


def _falcon_inputs(B, S):
    """x, dt, B, C, A, dy and states as falcon-mamba's layer makes them: B
    and C slices of its (B, S, 288) bf16 x_proj output."""
    x = torch.zeros(B, S, FALCON_D, dtype=torch.bfloat16)
    xp = torch.zeros(B, S, FALCON_ROW, dtype=torch.bfloat16)
    lo = FALCON_ROW - 2 * FALCON_N
    Bs, Cs = xp[..., lo:lo + FALCON_N], xp[..., lo + FALCON_N:]
    A = torch.zeros(FALCON_D, FALCON_N)
    dy = torch.zeros(B, S, FALCON_D)
    states = torch.zeros(ss.states_shape(B, S, FALCON_D, FALCON_N))
    return x, x.clone(), Bs, Cs, A, dy, states


@pytest.mark.parametrize("B,S", [(4, 512), (8, 1024)])
def test_main_path_shapes_take_the_tma_path(B, S):
    x, dt, Bs, Cs, A, dy, states = _falcon_inputs(B, S)
    assert Bs.stride(1) * 2 % 16 == 0 and Bs.data_ptr() % 16 == 0
    fwd = ss.plan_fused(x, dt, Bs, Cs, A)
    bwd = ss.plan_bwd(x, dt, Bs, Cs, A, dy, states)
    assert fwd.tma and bwd.tma
    _hold(fwd, B, S, FALCON_D, FALCON_N, ss.FWD_THREADS, bwd=False)
    assert bwd.partials[0] == (2, bwd.grid[0], B, S, FALCON_N)
    assert bwd.grid[0] * bwd.channels >= FALCON_D


def test_unaligned_rows_take_the_threads_path():
    x, dt, Bs, Cs, A, dy, states = _falcon_inputs(2, 40)
    assert ss.plan_fused(x, dt, Bs, Cs, A).tma
    xp = torch.zeros(2, 40, 5 + 2 * FALCON_N, dtype=torch.bfloat16)
    odd_b, odd_c = xp[..., 5:5 + FALCON_N], xp[..., 5 + FALCON_N:]
    assert not ss.plan_fused(x, dt, odd_b, Cs, A).tma
    assert not ss.plan_bwd(x, dt, Bs, odd_c, A, dy, states).tma
    narrow = torch.zeros(2, 40, 5, dtype=torch.bfloat16)   # d = 5
    assert not ss.plan_fused(narrow, narrow, Bs, Cs, A[:5]).tma


def _case_tensors(B, S, d, N, strided, dtype):
    x = torch.zeros(B, S, d, dtype=dtype)
    if strided == "aligned":
        row = torch.zeros(B, S, 16 + 2 * N, dtype=dtype)
        Bs, Cs = row[..., 16:16 + N], row[..., 16 + N:]
    elif strided:
        row = torch.zeros(B, S, 5 + 2 * N, dtype=dtype)
        Bs, Cs = row[..., 5:5 + N], row[..., 5 + N:]
    else:
        Bs, Cs = torch.zeros(B, S, N, dtype=dtype), torch.zeros(B, S, N,
                                                                 dtype=dtype)
    A = torch.zeros(d, N)
    return x, x.clone(), Bs, Cs, A, torch.zeros(B, S, d), torch.zeros(
        ss.states_shape(B, S, d, N))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,d,N,strided", FUSED_CASES)
def test_gpu_cases_take_the_path_their_layout_allows(B, S, d, N, strided,
                                                     dtype):
    """Rows of 5 + 2N elements from offset 5 never meet TMA's 16-byte
    alignment; the cases made for TMA meet it."""
    tensors = _case_tensors(B, S, d, N, strided, dtype)
    es = tensors[0].element_size()
    P = 1 << max(0, N - 1).bit_length()
    row = {False: N, True: 5 + 2 * N, "aligned": 16 + 2 * N}[strided]
    off = {False: 0, True: 5, "aligned": 16}[strided]
    want = (d * es % 16 == 0 and row * es % 16 == 0 and off * es % 16 == 0
            and P * es % 16 == 0)
    assert ss.plan_fused(*tensors[:5]).tma == want
    assert ss.plan_bwd(*tensors).tma == want
    if strided is True:
        assert not want
    if strided == "aligned" and N >= 8:
        assert want
