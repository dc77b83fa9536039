"""Selective scan: the K2 Hopper kernels' wrappers and their plain versions.

The kernel (``csrc/ssm_scan.cu``) replaces the JAX package's Pallas TPU
kernel ``ssm_scan_kernel`` (``repro/kernels/ssm_scan.py``): the diagonal
linear recurrence of Mamba1,

    h_t = decay_t ⊙ h_{t-1} + inc_t        (B, d, N) per step, h_0 = 0
    y_t = Σ_n h_t[..., n] · C_t[n]

with decay, inc (B, S, d, N) and C (B, S, N) read as f32 and y (B, S, d)
f32.  The TPU kernel's tiling (``chunk``, ``d_block``) has no counterpart:
the CUDA kernel takes any S and any d.  See the source's header for what
bounds it on an H100 and what its design does about that.

The same source has the fused form, the reference's default Mamba1 core
(``_mamba1_core_fused`` in ``repro/models/ssm.py``): x, dt, B, C and A go
in, decay = exp(dt·A) and inc = dt·x·B are built in registers, and y comes
out (:data:`ssm_scan_fused_cuda`).  Its backward (``csrc/ssm_scan_bwd.cu``,
:data:`ssm_scan_bwd_cuda`) recomputes each :data:`STATE_EVERY`-step segment
from the states the forward stores for it.

The fused forward gives a channel one thread, which holds its states in
registers; the backward gives it L lanes by state size
(:data:`BWD_LANES`), each holding N / L states.  Both stage their inputs
in shared memory through a ring refilled by TMA, or by the block's threads
where the rows are not 16-byte aligned.  :func:`fused_plan` and
:func:`bwd_plan` (on tensors: :func:`plan_fused`, :func:`plan_bwd`) say how
a launch splits its work: L, channels and passes a block, grid, shared
memory, the backward's partial sums and the load path; the wrappers launch
from them.

:func:`ssm_scan_plain`, :func:`mamba1_scan_plain` and
:func:`mamba1_scan_bwd_plain` are the same functions in torch.  They are
what runs for CPU tensors, and the versions the kernels are held against
on the card.  The ``*_cuda`` wrappers launch their kernels on CUDA tensors
and raise on anything they do not take; they never fall back.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.runtime import Allocs, empty, needs_grad

SOURCE = "ssm_scan.cu"
SOURCE_BWD = "ssm_scan_bwd.cu"
#: The kernels' names as the profiler shows them (substrings): the unfused
#: K2, the fused forward, and the backward's two kernels.
KERNEL_NAMES = ("ssm_scan_kernel",)
FUSED_KERNEL_NAMES = ("ssm_scan_fused_kernel",)
BWD_KERNEL_NAMES = ("ssm_scan_bwd_kernel", "ssm_scan_bwd_reduce_kernel")
#: Kernels one backward call launches: the main kernel, then the reduction
#: for dB, for dC and for dA.
BWD_LAUNCHES_PER_CALL = 4
#: Steps between the states the fused forward stores for the backward (the
#: sources' STATE_EVERY and T).
STATE_EVERY = 16
MAX_STATE = 32   # a channel's N states sit on the lanes of one warp
MAX_BATCH = 65535  # the batch is the launch grid's y dimension
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def diag_recurrence(decay, inc, h):
    """Every h_t of h_t = decay_t ⊙ h_{t-1} + inc_t along axis 1, from
    ``h``: decay, inc (B, c, ...) and h (B, ...) in f32 → (B, c, ...)."""
    hs = []
    for t in range(decay.shape[1]):
        h = decay[:, t] * h + inc[:, t]
        hs.append(h)
    return torch.stack(hs, 1)


def ssm_scan_plain(decay, inc, C, *, chunk: int = 256):
    """decay/inc: (B, S, d, N); C: (B, S, N) → y: (B, S, d) f32.

    The state is f32 and the inputs are cast to f32 ``chunk`` steps at a
    time; each chunk's states are reduced against C in one einsum.
    ``chunk`` sizes the work only, not the result's arithmetic.
    """
    B, S, d, N = decay.shape
    y = torch.empty((B, S, d), dtype=torch.float32, device=decay.device)
    h = torch.zeros((B, d, N), dtype=torch.float32, device=decay.device)
    for s0 in range(0, S, chunk):
        part = slice(s0, s0 + chunk)
        hs = diag_recurrence(decay[:, part].float(), inc[:, part].float(), h)
        h = hs[:, -1]
        y[:, part] = torch.einsum("bsdn,bsn->bsd", hs, C[:, part].float())
    return y


def decay_inc(dt, x, Bs, A):
    """The recurrence's inputs in f32: decay = exp(dt·A) and inc = dt·x·B,
    (..., di, N) from dt, x (..., di), Bs (..., N) and A (di, N)."""
    dtf = dt.float()
    decay = (dtf[..., None] * A).exp_()
    inc = (dtf * x.float())[..., None] * Bs.float()[..., None, :]
    return decay, inc


def mamba1_scan_plain(x, dt, Bs, Cs, A, *, chunk: int = 256):
    """The fused Mamba1 core from h_0 = 0: x, dt (B, S, d), Bs, Cs (B, S,
    N), A (d, N) → y (B, S, d) f32, with decay and inc built one ``chunk``
    of steps at a time (the reference's ``_mamba1_core_fused``, any S).
    ``chunk`` sizes the work only; autograd differentiates it."""
    B, S, d = x.shape
    h = x.new_zeros((B, d, A.shape[1]), dtype=torch.float32)
    ys = []
    for s0 in range(0, S, chunk):
        part = slice(s0, s0 + chunk)
        decay, inc = decay_inc(dt[:, part], x[:, part], Bs[:, part], A)
        hs = diag_recurrence(decay, inc, h)
        h = hs[:, -1]
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, Cs[:, part].float()))
    return torch.cat(ys, 1)


def scan_states_plain(x, dt, Bs, A, *, every: int = STATE_EVERY):
    """The states the fused forward stores for its backward: h before
    steps 0, every, 2·every, ... → (B, ceil(S / every), d, N) f32."""
    B, S, d = x.shape
    h = x.new_zeros((B, d, A.shape[1]), dtype=torch.float32)
    out = []
    for s0 in range(0, S, every):
        out.append(h)
        part = slice(s0, s0 + every)
        h = diag_recurrence(*decay_inc(dt[:, part], x[:, part], Bs[:, part],
                                       A), h)[:, -1]
    return torch.stack(out, 1) if out else h.new_zeros((B, 0, d, A.shape[1]))


def mamba1_scan_bwd_plain(x, dt, Bs, Cs, A, dy, *, every: int = STATE_EVERY):
    """The backward of :func:`mamba1_scan_plain` as the kernel walks it:
    the states every ``every`` steps, then each segment, last first,
    recomputed from its state and walked backward with g_t = dy_t·C_t +
    decay_{t+1}·g_{t+1}.  Returns (dx, ddt, dB, dC, dA) in the dtypes of
    x, dt, Bs, Cs and A."""
    B, S, d = x.shape
    xf, tf, bf, cf = (t.float() for t in (x, dt, Bs, Cs))
    dyf = dy.float()
    states = scan_states_plain(x, dt, Bs, A, every=every)
    dx, ddt = (torch.zeros_like(xf) for _ in range(2))
    dB, dC = (torch.zeros_like(bf) for _ in range(2))
    dA = torch.zeros_like(A, dtype=torch.float32)
    carry = torch.zeros_like(states[:, 0]) if S else None
    for k in reversed(range(states.shape[1])):
        t0 = k * every
        part = slice(t0, t0 + every)
        decay, inc = decay_inc(dt[:, part], x[:, part], Bs[:, part], A)
        hs = diag_recurrence(decay, inc, states[:, k])
        prev = torch.cat([states[:, k, None], hs[:, :-1]], 1)
        for i in reversed(range(hs.shape[1])):
            t = t0 + i
            g = dyf[:, t, :, None] * cf[:, t, None, :] + carry
            dd = g * prev[:, i] * decay[:, i]            # dL/d(dt·A)
            dA += (dd * tf[:, t, :, None]).sum(0)
            ddt[:, t] = (dd * A + g * xf[:, t, :, None]
                         * bf[:, t, None, :]).sum(-1)
            dx[:, t] = (g * tf[:, t, :, None] * bf[:, t, None, :]).sum(-1)
            dB[:, t] = (g * (tf[:, t] * xf[:, t])[..., None]).sum(1)
            dC[:, t] = (dyf[:, t, :, None] * hs[:, i]).sum(1)
            carry = decay[:, i] * g
    return (dx.to(x.dtype), ddt.to(dt.dtype), dB.to(Bs.dtype),
            dC.to(Cs.dtype), dA.to(A.dtype))


class SsmScanKernel:
    """The K2 kernel's wrapper.  ``launches`` counts kernel launches."""

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            from repro_torch.kernels import build
            fn = build.load(SOURCE).repro_ssm_scan_fwd
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, decay, inc, C):
        """Same contract as :func:`ssm_scan_plain`, on contiguous CUDA
        tensors, all three float32 or all three bfloat16, N ≤
        :data:`MAX_STATE`.  Forward only: inputs that require grad under
        grad mode raise (Mamba training comes with K2's backward)."""
        if decay.device.type != "cuda":
            raise ValueError(f"ssm scan kernel: decay is on {decay.device}, "
                             f"the kernel runs on CUDA tensors only")
        if inc.device != decay.device or C.device != decay.device:
            raise ValueError("ssm scan kernel: decay, inc, C on different "
                             "devices")
        if decay.dtype not in _DTYPE_CODE or inc.dtype != decay.dtype \
                or C.dtype != decay.dtype:
            raise TypeError(f"ssm scan kernel: dtypes {decay.dtype}/"
                            f"{inc.dtype}/{C.dtype}; needs one of "
                            f"{sorted(map(str, _DTYPE_CODE))} for all three")
        if decay.dim() != 4 or inc.shape != decay.shape or tuple(
                C.shape) != (*decay.shape[:2], decay.shape[3]):
            raise ValueError(f"ssm scan kernel: shapes {tuple(decay.shape)} "
                             f"{tuple(inc.shape)} {tuple(C.shape)}; needs "
                             f"(B, S, d, N) twice and (B, S, N)")
        if needs_grad(decay, inc, C):
            raise NotImplementedError(
                "ssm scan kernel: an input requires grad and K2 has no "
                "backward yet; its output would drop the gradient")
        B, S, d, N = decay.shape
        if not 1 <= N <= MAX_STATE or B > MAX_BATCH:
            raise ValueError(f"ssm scan kernel: state size {N} (takes 1 to "
                             f"{MAX_STATE}), batch {B} (at most {MAX_BATCH})")
        if not (decay.is_contiguous() and inc.is_contiguous()
                and C.is_contiguous()):
            raise ValueError("ssm scan kernel: decay, inc, C must be "
                             "contiguous")
        y = empty(scan_allocs(B, S, d, N).outputs[0], decay.device)
        if y.numel() == 0:
            return y
        with torch.cuda.device(decay.device):
            stream = torch.cuda.current_stream(decay.device).cuda_stream
            err = self._function()(
                _DTYPE_CODE[decay.dtype], decay.data_ptr(), inc.data_ptr(),
                C.data_ptr(), y.data_ptr(), B, S, d, N, stream)
        if err != 0:
            raise RuntimeError(f"ssm scan kernel failed to launch (error "
                               f"{err})")
        self.launches += 1
        return y


#: The process's one K2 wrapper; ``ssm_scan_cuda.launches`` is the count a
#: run reads to show that its path went through the kernel.
ssm_scan_cuda = SsmScanKernel()


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def states_shape(B: int, S: int, d: int, N: int):
    """Shape of the states the fused forward stores for its backward."""
    return (B, -(-S // STATE_EVERY), d, N)


def scan_allocs(B: int, S: int, d: int, N: int) -> Allocs:
    """What an unfused K2 call allocates: y (B, S, d) f32."""
    return Allocs((((B, S, d), torch.float32),))


def fused_allocs(B: int, S: int, d: int, N: int,
                 with_states: bool = False) -> Allocs:
    """What a fused K2 forward allocates: y (B, S, d) f32 and, for its
    backward, the states of :func:`states_shape` in f32 (allocated by
    ``ops.Mamba1ScanFunction`` beside the call)."""
    y = ((B, S, d), torch.float32)
    return Allocs((y, (states_shape(B, S, d, N), torch.float32))
                  if with_states else (y,))


def bwd_allocs(B: int, S: int, d: int, N: int, x_dtype, dt_dtype, b_dtype,
               c_dtype) -> Allocs:
    """What a K2 backward call allocates: dx, ddt (B, S, d) in x's and dt's
    dtypes, dB, dC (B, S, N) in B's and C's, dA (d, N) f32; and, freed when
    it returns, the partial sums of :func:`bwd_plan` and the f32 dB and dC
    the kernel writes where B's or C's dtype is not f32 (then cast)."""
    f32 = torch.float32
    plan = bwd_plan(B, S, d, N, x_dtype.itemsize, True)
    temps = tuple((shape, f32) for shape in plan.partials)
    temps += tuple(((B, S, N), f32) for t in (b_dtype, c_dtype) if t != f32)
    return Allocs((((B, S, d), x_dtype), ((B, S, d), dt_dtype),
                   ((B, S, N), b_dtype), ((B, S, N), c_dtype), ((d, N), f32)),
                  temps=temps)


#: The fused forward's blocks (the source's FT, TC and STAGES): threads (a
#: channel each), steps a stage, stages in the ring.
FWD_THREADS, FWD_STEPS, FWD_STAGES = 128, 32, 3
#: The backward's blocks (the source's NTB and STAGES; a stage holds a
#: segment of STATE_EVERY steps): threads and stages.
BWD_THREADS, BWD_STAGES = 128, 3
#: The backward's lanes a channel by P, the power of two at least N (the
#: source's ``lanes_for``): a lane holds P / L states, at most 8; forms with
#: fewer states on more lanes spilled under ptxas.
BWD_LANES = {1: 1, 2: 1, 4: 1, 8: 2, 16: 4, 32: 4}
#: The backward's blocks walk as many channel groups (passes) as leave the
#: grid this many blocks, so that the partial sums of dB and dC stay small.
BWD_TARGET_BLOCKS = 512
BWD_MAX_CHANNELS = 256   # a tile's width: TMA's largest box
#: Dynamic shared memory a block may have on an H100.
SMEM_LIMIT = 232_448


def _a128(n: int) -> int:
    return -(-n // 128) * 128


class ScanPlan(NamedTuple):
    """How a fused-forward or backward launch splits its work: what the
    wrapper passes to the kernel, and what ``chip_smoke.py`` prints."""
    lanes: int          # L: a channel's lanes
    lane_states: int    # NL = P / L states a lane (P: the power of two >= N)
    channels: int       # channels a block: passes x threads / L
    passes: int         # channel groups a block walks (1 in the forward)
    grid: Tuple[int, int]   # (blocks along d, B)
    stages: int         # stages of the ring of staged inputs
    steps: int          # steps a stage holds
    smem_bytes: int     # dynamic shared memory a block
    partials: Tuple[Tuple[int, ...], ...]   # backward: part_bc, part_a
    tma: bool           # staged by TMA (else by the block's threads)


def tma_aligned(itemsize: int, d: int, row_strides, pointers) -> bool:
    """Whether TMA can load the rows: every base 16-byte aligned, x, dt
    and dy rows (``d`` elements) and B and C rows (``row_strides``) a
    multiple of 16 bytes apart."""
    return (all(p % 16 == 0 for p in pointers) and d * itemsize % 16 == 0
            and all(r * itemsize % 16 == 0 for r in row_strides))


def fused_plan(B: int, S: int, d: int, N: int, itemsize: int,
               aligned: bool) -> ScanPlan:
    """The fused forward's plan: one lane a channel holding its P states,
    FWD_THREADS channels a block, TMA loads where ``aligned`` and a B row
    of P elements is a multiple of 16 bytes."""
    P = _pow2_at_least(N)
    ch = FWD_THREADS
    smem = FWD_STAGES * (2 * _a128(FWD_STEPS * ch * itemsize)
                         + 2 * _a128(FWD_STEPS * P * itemsize)) + 128
    return ScanPlan(1, P, ch, 1, (-(-d // ch), B), FWD_STAGES, FWD_STEPS,
                    smem, (), aligned and P * itemsize % 16 == 0)


def _bwd_smem(itemsize: int, L: int, P: int, N: int, passes: int) -> int:
    chb = BWD_THREADS // L * passes
    T = STATE_EVERY
    stage = (2 * _a128(T * chb * itemsize) + _a128(T * chb * 4)
             + 2 * _a128(T * P * itemsize) + _a128(chb * N * 4))
    red = _a128(2 * T * (BWD_THREADS // 32) * 2 * P * 4)
    carry = _a128(2 * passes * (P // L) * BWD_THREADS * 4)
    return BWD_STAGES * stage + red + carry + 128


def bwd_plan(B: int, S: int, d: int, N: int, itemsize: int,
             aligned: bool) -> ScanPlan:
    """The backward's plan: :data:`BWD_LANES` lanes a channel, as many
    passes of BWD_THREADS / L channels a block as leave
    :data:`BWD_TARGET_BLOCKS` blocks, and TMA loads as the forward's."""
    P = _pow2_at_least(N)
    L = BWD_LANES[P]
    ch = BWD_THREADS // L
    passes = 1
    while (ch * passes * 2 <= BWD_MAX_CHANNELS
           and B * -(-d // (ch * passes * 2)) >= BWD_TARGET_BLOCKS
           and _bwd_smem(itemsize, L, P, N, passes * 2) <= SMEM_LIMIT):
        passes *= 2
    slabs = -(-d // (ch * passes))
    return ScanPlan(L, P // L, ch * passes, passes, (slabs, B), BWD_STAGES,
                    STATE_EVERY, _bwd_smem(itemsize, L, P, N, passes),
                    ((2, slabs, B, S, N), (B, d, N)),
                    aligned and P * itemsize % 16 == 0)


def _check_fused_inputs(what, x, dt, Bs, Cs, A):
    """The fused kernels' contract, checked on the host before a launch:
    raises on what the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x is on {x.device}, the kernel runs on "
                         f"CUDA tensors only")
    if any(t.device != x.device for t in (dt, Bs, Cs, A)):
        raise ValueError(f"{what}: x, dt, B, C, A on different devices")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype
                                         for t in (dt, Bs, Cs)):
        raise TypeError(f"{what}: dtypes {x.dtype}/{dt.dtype}/{Bs.dtype}/"
                        f"{Cs.dtype}; needs one of "
                        f"{sorted(map(str, _DTYPE_CODE))} for x, dt, B, C")
    if A.dtype != torch.float32:
        raise TypeError(f"{what}: A is {A.dtype}, needs float32")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"{what}: x {tuple(x.shape)}, A {tuple(A.shape)}; "
                         f"needs (B, S, d) and (d, N)")
    B, S, d = x.shape
    N = A.shape[1]
    if tuple(dt.shape) != (B, S, d) or tuple(A.shape) != (d, N) or any(
            tuple(t.shape) != (B, S, N) for t in (Bs, Cs)):
        raise ValueError(f"{what}: shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} B {tuple(Bs.shape)} C "
                         f"{tuple(Cs.shape)} A {tuple(A.shape)}; needs "
                         f"(B, S, d) twice, (B, S, N) twice and (d, N)")
    if not 1 <= N <= MAX_STATE or B > MAX_BATCH:
        raise ValueError(f"{what}: state size {N} (takes 1 to {MAX_STATE}), "
                         f"batch {B} (at most {MAX_BATCH})")
    if not (x.is_contiguous() and dt.is_contiguous() and A.is_contiguous()):
        raise ValueError(f"{what}: x, dt and A must be contiguous")
    for name, t in (("B", Bs), ("C", Cs)):
        if S > 0 and (t.stride(2) != 1 or t.stride(0) != S * t.stride(1)):
            raise ValueError(f"{what}: {name} has strides {t.stride()}; needs "
                             f"unit element stride and evenly spaced rows")
    return B, S, d, N


def _check_f32(what, name, t, device, shape) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(
            t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: {name} {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}; needs a contiguous float32 "
                         f"{tuple(shape)} on {device}")


def plan_fused(x, dt, Bs, Cs, A) -> ScanPlan:
    """:func:`fused_plan` for these inputs (the fused wrapper's plan)."""
    B, S, d = x.shape
    return fused_plan(B, S, d, A.shape[1], x.element_size(), tma_aligned(
        x.element_size(), d, (Bs.stride(1), Cs.stride(1)),
        [t.data_ptr() for t in (x, dt, Bs, Cs)]))


def plan_bwd(x, dt, Bs, Cs, A, dy, states) -> ScanPlan:
    """:func:`bwd_plan` for these inputs (the backward wrapper's plan)."""
    B, S, d = x.shape
    return bwd_plan(B, S, d, A.shape[1], x.element_size(), tma_aligned(
        x.element_size(), d, (Bs.stride(1), Cs.stride(1)),
        [t.data_ptr() for t in (x, dt, Bs, Cs, dy, states)]))


class SsmScanFusedKernel:
    """The fused K2 forward's wrapper.  ``launches`` counts launches;
    ``last_plan`` is the plan of the last launch."""

    def __init__(self) -> None:
        self.launches = 0
        self.last_plan: Optional[ScanPlan] = None
        self._fn = None

    def _function(self):
        if self._fn is None:
            from repro_torch.kernels import build
            lib = build.load(SOURCE)
            if lib.repro_ssm_scan_state_every() != STATE_EVERY:
                raise RuntimeError("ssm scan kernel: the source stores states "
                                   "at another interval than STATE_EVERY")
            fn = lib.repro_ssm_scan_fused_fwd
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                           + [ctypes.c_longlong, ctypes.c_void_p,
                              ctypes.c_longlong] + [ctypes.c_void_p] * 3
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, x, dt, Bs, Cs, A, *,
                 states: Optional[torch.Tensor] = None):
        """Same function as :func:`mamba1_scan_plain`: x, dt (B, S, d)
        contiguous, Bs, Cs (B, S, N) with unit element stride (row slices of
        a wider tensor go in as they are), all four float32 or all four
        bfloat16, A (d, N) float32, N ≤ :data:`MAX_STATE` → y (B, S, d)
        f32.  With ``states`` (a contiguous float32 buffer of
        :func:`states_shape`) it also writes the state before every
        :data:`STATE_EVERY`-th step, for the backward.  Inputs that require
        grad under grad mode raise: autograd goes through
        ``ops.Mamba1ScanFunction``."""
        what = "fused ssm scan kernel"
        B, S, d, N = _check_fused_inputs(what, x, dt, Bs, Cs, A)
        if needs_grad(x, dt, Bs, Cs, A):
            raise NotImplementedError(
                f"{what}: an input requires grad; call ops.mamba1_scan, whose "
                f"autograd Function runs the backward kernel")
        if states is not None:
            _check_f32(what, "states", states, x.device,
                       states_shape(B, S, d, N))
        plan = plan_fused(x, dt, Bs, Cs, A)
        y = empty(fused_allocs(B, S, d, N).outputs[0], x.device)
        if y.numel() == 0:
            return y
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = self._function()(
                _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(),
                Bs.data_ptr(), Bs.stride(1), Cs.data_ptr(), Cs.stride(1),
                A.data_ptr(), y.data_ptr(),
                None if states is None else states.data_ptr(), B, S, d, N,
                int(plan.tma), plan.smem_bytes, stream)
        if err != 0:
            raise RuntimeError(f"{what} failed to launch (error {err})")
        self.launches += 1
        self.last_plan = plan
        return y


class SsmScanBwdKernel:
    """K2's backward wrapper (the main kernel and its reduction, one call).
    ``launches`` counts kernel launches: each call on inputs that are not
    empty launches :data:`BWD_LAUNCHES_PER_CALL`; ``last_plan`` is the
    plan of the last call."""

    def __init__(self) -> None:
        self.launches = 0
        self.last_plan: Optional[ScanPlan] = None
        self._fn = None

    def _function(self):
        if self._fn is None:
            from repro_torch.kernels import build
            lib = build.load(SOURCE_BWD)
            if lib.repro_ssm_scan_bwd_state_every() != STATE_EVERY:
                raise RuntimeError("ssm scan backward: the source reads states "
                                   "at another interval than STATE_EVERY")
            fn = lib.repro_ssm_scan_bwd
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                           + [ctypes.c_longlong, ctypes.c_void_p,
                              ctypes.c_longlong] + [ctypes.c_void_p] * 10
                           + [ctypes.c_int] * 8 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, x, dt, Bs, Cs, A, dy, states):
        """The gradients of :func:`mamba1_scan_plain` for ``dy`` (B, S, d)
        f32 from the forward's ``states``: (dx, ddt, dB, dC, dA) in the
        dtypes of x, dt, Bs, Cs and A (dx and ddt written so by the kernel,
        each rounded once).  The inputs as the fused forward takes them; dy
        and states contiguous float32."""
        what = "ssm scan backward kernel"
        B, S, d, N = _check_fused_inputs(what, x, dt, Bs, Cs, A)
        _check_f32(what, "dy", dy, x.device, (B, S, d))
        _check_f32(what, "states", states, x.device,
                   states_shape(B, S, d, N))
        plan = plan_bwd(x, dt, Bs, Cs, A, dy, states)
        allocs = bwd_allocs(B, S, d, N, x.dtype, dt.dtype, Bs.dtype,
                            Cs.dtype)
        dx, ddt = (empty(a, x.device) for a in allocs.outputs[:2])
        # the kernel writes dB and dC in f32, cast after it to B's and C's
        dB, dC = (empty((shape, torch.float32), x.device)
                  for shape, _ in allocs.outputs[2:4])
        dA = empty(allocs.outputs[4], x.device)
        if x.numel() > 0:
            part_bc, part_a = (empty(a, x.device) for a in allocs.temps[:2])
            with torch.cuda.device(x.device):
                stream = torch.cuda.current_stream(x.device).cuda_stream
                err = self._function()(
                    _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(),
                    Bs.data_ptr(), Bs.stride(1), Cs.data_ptr(), Cs.stride(1),
                    A.data_ptr(), dy.data_ptr(), states.data_ptr(),
                    dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
                    dC.data_ptr(), dA.data_ptr(), part_bc.data_ptr(),
                    part_a.data_ptr(), B, S, d, N, plan.passes, plan.grid[0],
                    int(plan.tma), plan.smem_bytes, stream)
            if err != 0:
                raise RuntimeError(f"{what} failed to launch (error {err})")
            self.launches += BWD_LAUNCHES_PER_CALL
            self.last_plan = plan
        else:
            for t in (dB, dC, dA):
                t.zero_()
        return dx, ddt, dB.to(Bs.dtype), dC.to(Cs.dtype), dA


#: The process's fused K2 forward and K2 backward wrappers; their
#: ``launches`` are the counts a run reads to show that its path went
#: through the kernels.
ssm_scan_fused_cuda = SsmScanFusedKernel()
ssm_scan_bwd_cuda = SsmScanBwdKernel()
