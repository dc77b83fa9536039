"""Flash attention: the K1 Hopper kernels' wrapper and their plain versions.

The kernels (``csrc/flash_attention.cu``) replace the JAX package's Pallas
TPU kernel ``flash_attention_kernel`` (``repro/kernels/flash_attention.py``)
and cover what the model path needs beyond it: the model's (B, S, H, D)
layout, a query offset that lives in device memory (decode), the causal
and window masks and a ragged Skv.  One wrapper, two regimes: Sq > 1 goes
to the prefill kernel (tensor cores for bf16, an FMA kernel for f32), Sq =
1 to the split-KV decode kernel.  See the source's header for what bounds
each on an H100 and what its design does about that.

:func:`flash_attention_plain` is the port of ``repro.models.layers.
flash_attention``: an online softmax scanned over kv chunks.  It is what
runs for CPU tensors, and the version the kernels are held against on the
card.  :func:`flash_attention_split_plain` repeats the decode kernel's
arithmetic (per-split partials, merged in split order) for the tests.
:data:`flash_attention_cuda` launches a kernel on CUDA tensors and raises
on anything neither kernel takes; it never falls back.

The gradient (``csrc/flash_attention_bwd.cu``, FlashAttention-2's
backward: a preprocess, a dK/dV kernel and a dQ kernel) has no Pallas
counterpart: JAX differentiates the plain ``flash_attention``.
:data:`flash_attention_bwd_cuda` launches it from the prefill kernels'
log-sum-exp (:func:`lse_plain` is that statistic's plain version,
:func:`delta_plain` the preprocess's); its plain version is autograd of
:func:`flash_attention_plain` (:func:`flash_attention_bwd_plain`).
:func:`bwd_plan` gives the tiles the bf16 backward kernels walk and sizes
their grids.  ``ops.flash_attention`` ties the two kernels into autograd.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.runtime import Allocs, empty, needs_grad

SOURCE = "flash_attention.cu"
#: Head dims the forward kernels are instantiated for (80: zamba2, 256:
#: gemma3).
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
MAX_GROUP = 64   # a prefill block's 64 rows hold at least one position
DECODE_SPLIT = 64   # keys per decode split (SPLIT in the source)
#: The kernels' names, as a profiler shows them.
KERNEL_NAMES = ("flash_prefill_kernel", "flash_prefill_f32_kernel",
                "flash_decode_kernel")
BWD_SOURCE = "flash_attention_bwd.cu"
#: Head dims the backward kernels are instantiated for (80: zamba2, its
#: 160-byte rows in two 128-byte swizzled column blocks, the second padded
#: with zeros by TMA; 256: gemma3, kernels of their own).
BWD_HEAD_DIMS = (16, 32, 64, 80, 128, 256)
#: The head dim whose bf16 kernels split a tile's products between their
#: two warpgroups (WIDE in the source).
BWD_WIDE = 256
#: The backward's kernels, as a profiler shows them: the preprocess, then
#: dK/dV and dQ (wgmma and TMA for bf16, their own at BWD_WIDE; FMA kernels
#: for f32).
BWD_KERNEL_NAMES = ("flash_bwd_preprocess_kernel", "flash_bwd_dkdv_kernel",
                    "flash_bwd_dq_kernel", "flash_bwd_dkdv_wide_kernel",
                    "flash_bwd_dq_wide_kernel", "flash_bwd_dkdv_fma_kernel",
                    "flash_bwd_dq_fma_kernel")
#: Kernels one backward call launches, whatever the dtype.
BWD_LAUNCHES_PER_CALL = 3
#: The bf16 backward kernels: rows of every tile a warpgroup owns or walks
#: (ROWS in the source).
BWD_TILE = 64
#: The f32 dQ kernel's query rows a block at BWD_WIDE: a block holds whole
#: positions, so the group may be at most this.
BWD_F32_WIDE_ROWS = 32
LOG2E = 1.4426950408889634
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

QOffset = Union[int, torch.Tensor]


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, kv_chunk: int = 512,
                          q_offset: QOffset = 0):
    """Online-softmax attention, scanned over kv chunks.

    q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D) with H % Hkv == 0 (GQA: kv
    heads repeated to H chunk by chunk).  ``window`` masks keys ``window``
    or more positions older than the query; None disables it.
    ``q_offset`` (int or 0-d integer tensor) is the absolute position of
    q[:, 0].  Softmax statistics and accumulation in f32; p is cast to v's
    dtype before the PV product.
    """
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    assert H % Hkv == 0, (H, Hkv)
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    kv_chunk = min(kv_chunk, Skv)
    n_chunks = math.ceil(Skv / kv_chunk)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    acc = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, Sq, H), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=q.device)
    for j in range(n_chunks):
        kj = k[:, j * kv_chunk:(j + 1) * kv_chunk]
        vj = v[:, j * kv_chunk:(j + 1) * kv_chunk]
        if rep > 1:
            kj = kj.repeat_interleave(rep, dim=2)
            vj = vj.repeat_interleave(rep, dim=2)
        s = torch.einsum("bshd,bchd->bshc", q.float(), kj.float()) * scale
        kv_pos = j * kv_chunk + torch.arange(kj.shape[1], device=q.device)
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((Sq, kj.shape[1]), dtype=torch.bool,
                              device=q.device)
        if window is not None:
            mask = mask & ((q_pos[:, None] - kv_pos[None, :]) < window)
        mask = mask[None, :, None, :]
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bshc,bchd->bshd", p.to(vj.dtype).float(),
                          vj.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-37)
    return out.to(q.dtype)


@dataclass(frozen=True)
class DecodePlan:
    """Grid and scratch of one decode launch, fixed by the cache capacity
    alone (never by the live length, which lives on the device)."""
    n_splits: int
    split: int
    grid: Tuple[int, int, int]     # (n_splits, Hkv, B)
    scratch_floats: int            # m, l and acc per (b, kv head, split)
    tickets: int                   # one per (b, kv head)
    Skv: int

    @property
    def key_ranges(self) -> List[Tuple[int, int]]:
        """[lo, hi) of each split, in split order."""
        return [(s * self.split, min((s + 1) * self.split, self.Skv))
                for s in range(self.n_splits)]


def decode_plan(Skv: int, split: int = DECODE_SPLIT, *, B: int = 1,
                Hkv: int = 1, group: int = 1, D: int = 128) -> DecodePlan:
    """The decode kernel's plan for a cache of capacity ``Skv``: split s
    covers keys [s * split, min((s + 1) * split, Skv))."""
    if Skv < 1 or split < 1:
        raise ValueError(f"decode plan: Skv {Skv}, split {split}")
    n = -(-Skv // split)
    return DecodePlan(
        n_splits=n, split=split, grid=(n, Hkv, B),
        scratch_floats=B * Hkv * n * group * (D + 2), tickets=B * Hkv,
        Skv=Skv)


def fwd_allocs(B: int, Sq: int, H: int, D: int, Skv: int, Hkv: int,
               dtype: torch.dtype, *, with_lse: bool = False,
               out_f32: bool = False) -> Allocs:
    """What a forward call allocates: the output (B, Sq, H, D) in q's
    dtype (f32 with ``out_f32``) and, with ``with_lse``, the log-sum-exp
    (B, H, Sq) f32; for Sq = 1 the decode kernel's scratch and tickets of
    :func:`decode_plan`, which the wrapper keeps per (device, stream)."""
    out = ((B, Sq, H, D), torch.float32 if out_f32 else dtype)
    outputs = (out, ((B, H, Sq), torch.float32)) if with_lse else (out,)
    if Sq != 1:
        return Allocs(outputs)
    plan = decode_plan(Skv, B=B, Hkv=Hkv, group=H // Hkv, D=D)
    return Allocs(outputs, workspace=(((plan.scratch_floats,), torch.float32),
                                      ((plan.tickets,), torch.int32)))


def bwd_allocs(B: int, Sq: int, H: int, D: int, Skv: int, Hkv: int,
               dtype: torch.dtype) -> Allocs:
    """What a backward call allocates: dq (B, Sq, H, D), dk and dv (B,
    Skv, Hkv, D) in q's dtype, and the preprocess's delta (B, H, Sq) f32,
    freed when the call returns."""
    return Allocs((((B, Sq, H, D), dtype), ((B, Skv, Hkv, D), dtype),
                   ((B, Skv, Hkv, D), dtype)),
                  temps=(((B, H, Sq), torch.float32),))


@dataclass(frozen=True)
class BwdWalk:
    """One warpgroup of a bf16 backward block: the :data:`BWD_TILE` rows it
    owns, [rows, rows + BWD_TILE) (keys for dK/dV, query positions for dQ,
    some maybe past the end), and the tiles of :data:`BWD_TILE` it visits,
    each as its first query position (dK/dV) or key (dQ) and whether the
    kernel evaluates masks on it."""
    rows: int
    tiles: Tuple[Tuple[int, bool], ...]


@dataclass(frozen=True)
class BwdBlock:
    """A bf16 backward block: the tiles it loads (the union of its walks,
    in walk order) and its walks, one for each tile of rows it owns."""
    tiles: Tuple[int, ...]
    walks: Tuple[BwdWalk, ...]


def bwd_block(D: int) -> int:
    """Rows (keys for dK/dV, positions for dQ) a bf16 backward block owns:
    one tile for each of its two warpgroups, or at :data:`BWD_WIDE` one
    tile whose products the two split."""
    return BWD_TILE if D == BWD_WIDE else 2 * BWD_TILE


@dataclass(frozen=True)
class BwdPlan:
    """The walks of the bf16 backward kernels for one (b, head): the dK/dV
    kernel's blocks of ``block`` keys of a kv head, each walking its tiles
    once for each of the ``group`` q heads, and the dQ kernel's blocks of
    ``block`` positions of a q head.  The grids are these blocks times
    (Hkv, B) and (H, B)."""
    dkdv: Tuple[BwdBlock, ...]
    dq: Tuple[BwdBlock, ...]
    group: int
    block: int


def _dkdv_tiles(j0, Sq, Skv, causal, window, q_offset):
    """First positions of the tiles that see a key of [j0, j0 + BWD_TILE)."""
    j1 = min(j0 + BWD_TILE, Skv)
    p_lo = max(0, j0 - q_offset) if causal else 0
    p_hi = Sq if window is None else min(Sq, j1 - 1 + window - q_offset)
    if j0 >= j1 or (causal and window == 0) or p_lo >= p_hi:
        return []
    return [t * BWD_TILE for t in range(p_lo // BWD_TILE,
                                        -(-p_hi // BWD_TILE))]


def _dq_tiles(p0, Sq, Skv, causal, window, q_offset):
    """First keys of the tiles that a position of [p0, p0 + BWD_TILE)
    sees."""
    p1 = min(p0 + BWD_TILE, Sq)
    k_lo = 0 if window is None else max(0, p0 + q_offset - window + 1)
    k_hi = min(Skv, p1 + q_offset) if causal else Skv
    if p0 >= p1 or (causal and window == 0) or k_lo >= k_hi:
        return []
    return [t * BWD_TILE for t in range(k_lo // BWD_TILE,
                                        -(-k_hi // BWD_TILE))]


def _unmasked(p0, k0, Sq, Skv, causal, window, q_offset):
    """No pair of BWD_TILE positions from p0 and BWD_TILE keys from k0 is
    masked (the source's ``mask_free``)."""
    last = BWD_TILE - 1
    return (p0 + BWD_TILE <= Sq and k0 + BWD_TILE <= Skv
            and (not causal or k0 + last <= p0 + q_offset)
            and (window is None or p0 + last + q_offset - k0 < window))


@functools.lru_cache(maxsize=256)
def bwd_plan(Sq: int, Skv: int, group: int = 1, causal: bool = True,
             window: Optional[int] = None, q_offset: int = 0,
             D: int = 128) -> BwdPlan:
    """The tiles each bf16 backward block visits at head dim ``D``, as the
    kernels compute them (``dkdv_walk``, ``dq_walk``, ``block_walk`` and
    ``mask_free`` in the source): the walk of a tile of keys (dK/dV) visits
    the tiles of query positions that see one of its keys, the walk of a
    tile of positions (dQ) the tiles of keys that one of its positions
    sees, and a tile needs masks when it crosses the causal diagonal, the
    window's edge, Sq or Skv.  Masks depend on the position alone, so
    every q head of a group walks the same tiles."""
    if Sq < 1 or Skv < 1 or group < 1:
        raise ValueError(f"bwd plan: Sq {Sq}, Skv {Skv}, group {group}")
    masks = (Sq, Skv, causal, window, q_offset)
    rows_per_block = bwd_block(D)

    def block(start, tiles_of, pair):
        walks = []
        for rows in range(start, start + rows_per_block, BWD_TILE):
            walks.append(BwdWalk(rows, tuple(
                (t, not _unmasked(*pair(rows, t), *masks))
                for t in tiles_of(rows, *masks))))
        union = sorted({t for w in walks for t, _ in w.tiles})
        return BwdBlock(tuple(union), tuple(walks))

    dkdv = tuple(block(j, _dkdv_tiles, lambda rows, t: (t, rows))
                 for j in range(0, Skv, rows_per_block))
    dq = tuple(block(p, _dq_tiles, lambda rows, t: (rows, t))
               for p in range(0, Sq, rows_per_block))
    return BwdPlan(dkdv=dkdv, dq=dq, group=group, block=rows_per_block)


def flash_attention_split_plain(q, k, v, *, causal: bool = True,
                                window: Optional[int] = None,
                                q_offset: QOffset = 0,
                                split: int = DECODE_SPLIT):
    """One-token attention (Sq = 1) as the decode kernel computes it.

    Each split of :func:`decode_plan` yields a partial over its live keys:
    m = max s, p = exp(s - m), l = sum p (f32) and acc = sum p v with p
    cast to v's dtype.  The partials are merged in split order with weights
    exp(m - M); a split with no live key adds nothing.  Output acc / max(l,
    1e-37) in q's dtype.  Same arguments as :func:`flash_attention_plain`.
    """
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    assert Sq == 1 and H % Hkv == 0, (q.shape, k.shape)
    group = H // Hkv
    plan = decode_plan(Skv, split)
    kv = torch.arange(Skv, device=q.device)
    live = kv <= q_offset if causal else torch.ones_like(kv, dtype=torch.bool)
    if window is not None:
        live = live & ((q_offset - kv) < window)
    qg = q[:, 0].float().reshape(B, Hkv, group, D)
    s = torch.einsum("bhgd,bchd->bhgc", qg, k.float()) * (1.0 / math.sqrt(D))
    M = torch.full((B, Hkv, group), -math.inf, device=q.device)
    parts = []
    for lo, hi in plan.key_ranges:
        ok = live[lo:hi]
        sj = torch.where(ok, s[..., lo:hi], -math.inf)
        m = sj.amax(dim=-1)
        p = torch.where(ok, torch.exp(sj - torch.where(
            torch.isfinite(m), m, 0.0)[..., None]), 0.0)
        acc = torch.einsum("bhgc,bchd->bhgd", p.to(v.dtype).float(),
                           v[:, lo:hi].float())
        parts.append((m, p.sum(dim=-1), acc))
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    out = torch.zeros((B, Hkv, group, D), device=q.device)
    for m, l, acc in parts:          # in split order, as the kernel merges
        w = torch.where(torch.isfinite(m), torch.exp(m - M), 0.0)
        L = L + w * l
        out = out + w[..., None] * acc
    out = out / torch.clamp(L[..., None], min=1e-37)
    return out.reshape(B, 1, H, D).to(q.dtype)


def lse_plain(q, k, v, *, causal: bool = True,
              window: Optional[int] = None, q_offset: int = 0):
    """The prefill kernels' log-sum-exp output, (B, H, Sq) f32: the
    natural log-sum-exp of each row's valid scores q.k/sqrt(D), times
    log2(e) (the base-2 units the backward recomputes P in); -inf for a
    row with no valid key.  Same arguments as
    :func:`flash_attention_plain`."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    kr = k.float().repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bshd,bchd->bhsc", q.float(), kr) / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = kv_pos <= q_pos if causal else torch.ones_like(
        kv_pos <= q_pos)
    if window is not None:
        mask = mask & ((q_pos - kv_pos) < window)
    s = torch.where(mask, s, -math.inf)
    return torch.logsumexp(s, dim=-1) * LOG2E


def delta_plain(out, dout):
    """The backward's preprocess: rowsum(dO * O) in f32, (B, H, Sq)."""
    return (out.float() * dout.float()).sum(-1).transpose(1, 2)


def flash_attention_bwd_plain(q, k, v, dout, *, causal: bool = True,
                              window: Optional[int] = None, q_offset: int = 0):
    """(dq, dk, dv) of :func:`flash_attention_plain` by autograd, in f32
    from q, k, v and dO upcast to f32: the version the backward kernels
    are held against."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
        out = flash_attention_plain(*leaves, causal=causal, window=window,
                                    q_offset=q_offset)
        return torch.autograd.grad(out, leaves, dout.float())


def _check_qkv(q, k, v, what: str, device_type: str = "cuda"):
    """The checks every K1 launch makes (on ``device_type`` tensors: the
    meta path checks what the kernels take too); returns (B, Sq, H, D,
    Skv, Hkv)."""
    if q.device.type != device_type:
        kind = "CUDA" if device_type == "cuda" else device_type
        raise ValueError(f"{what}: q is on {q.device}, the kernel runs on "
                         f"{kind} tensors only")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: q, k, v on different devices")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{what}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        f"needs one of {sorted(map(str, _DTYPE_CODE))} for "
                        f"all three")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if D not in HEAD_DIMS or H // Hkv > MAX_GROUP:
        raise ValueError(f"{what}: head dim {D} (takes {HEAD_DIMS}), group "
                         f"{H // Hkv} (at most {MAX_GROUP})")
    if not all(map(_aligned, (q, k, v))):
        raise ValueError(f"{what}: q, k, v need a contiguous head dim and "
                         f"16-byte aligned rows")
    return B, Sq, H, D, Skv, Hkv


def _check_window(window, what: str) -> None:
    if window is not None and not isinstance(window, int):
        raise TypeError(f"{what}: window must be an int or None")
    if window is not None and window < 0:
        raise ValueError(f"{what}: window {window} < 0")


def _aligned(t: torch.Tensor) -> bool:
    """Head dim contiguous, every row start on a 16-byte boundary."""
    item = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all((s * item) % 16 == 0 for s in t.stride()[:-1]))


_COMMON_ARGS = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5)


class FlashAttentionKernel:
    """The K1 kernels' wrapper.  ``launches`` counts kernel launches, one
    per call whichever kernel it takes; ``decode_lse_launches`` those of
    the decode kernel asked for its log-sum-exp (sequence-parallel
    decode), which ``launches`` counts too."""

    def __init__(self) -> None:
        self.launches = 0
        self.decode_lse_launches = 0
        self._fns = None
        #: (device index, stream) -> (scratch, tickets) of the decode kernel:
        #: allocated once, grown when a call needs more, never cleared (the
        #: kernel leaves its tickets at 0).
        self._buffers: Dict[Tuple[int, int],
                            Tuple[torch.Tensor, torch.Tensor]] = {}

    def _functions(self):
        if self._fns is None:
            from repro_torch.kernels import build
            lib = build.load(SOURCE)
            prefill, decode = lib.repro_flash_prefill, lib.repro_flash_decode
            prefill.argtypes = (_COMMON_ARGS + [ctypes.c_int] * 7
                                + [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_void_p,
                                   ctypes.c_void_p])
            decode.argtypes = (_COMMON_ARGS + [ctypes.c_int] * 6
                               + [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_float, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p])
            prefill.restype = decode.restype = ctypes.c_int
            self._fns = (prefill, decode)
        return self._fns

    def _decode_buffers(self, device, stream: int, workspace):
        """The scratch and tickets of ``workspace`` (:func:`fwd_allocs`'s)
        for (device, stream), grown to fit it."""
        key = (device.index, stream)
        have = self._buffers.get(key)
        (floats,), _ = workspace[0]
        (tickets,), _ = workspace[1]
        if have is None or have[0].numel() < floats \
                or have[1].numel() < tickets:
            floats = max(floats, 0 if have is None else have[0].numel())
            tickets = max(tickets, 0 if have is None else have[1].numel())
            have = (torch.empty(floats, dtype=torch.float32, device=device),
                    torch.zeros(tickets, dtype=torch.int32, device=device))
            self._buffers[key] = have
        return have

    def __call__(self, q, k, v, *, causal: bool = True,
                 window: Optional[int] = None, q_offset: QOffset = 0,
                 with_lse: bool = False, out_f32: bool = False):
        """Same contract as :func:`flash_attention_plain`, on CUDA tensors
        of float32 or bfloat16 with head dim in :data:`HEAD_DIMS`.

        ``with_lse=True`` returns ``(out, lse)`` with the rows'
        log-sum-exp as :func:`lse_plain` defines it, (B, H, Sq) f32: from
        the prefill kernel, or (Sq = 1) from the decode kernel, where a
        row with no live key (a query offset below 0 included) gets
        -inf.  ``out_f32=True`` (Sq = 1 only) has the decode kernel write
        its output in f32 rather than q's dtype: sequence-parallel decode
        merges its shards' outputs before the one rounding.  The output
        carries no gradient, so inputs that require one under grad mode
        raise: ``ops.flash_attention`` is the differentiable entry.
        """
        what = "flash attention kernel"
        B, Sq, H, D, Skv, Hkv = _check_qkv(q, k, v, what)
        _check_window(window, what)
        if needs_grad(q, k, v):
            raise RuntimeError(f"{what}: q, k or v requires grad; its output "
                               f"would drop it (call ops.flash_attention)")
        if out_f32 and Sq != 1:
            raise ValueError(f"{what}: out_f32 is the decode kernel's "
                             f"(Sq = 1)")
        offset_ptr, offset = None, 0
        if isinstance(q_offset, torch.Tensor):
            if q_offset.device != q.device or q_offset.dtype != torch.int32 \
                    or q_offset.numel() != 1 or not q_offset.is_contiguous():
                raise ValueError("flash attention kernel: a tensor q_offset "
                                 "must be one int32 on q's device")
            offset_ptr = q_offset.data_ptr()
        else:
            offset = int(q_offset)
        allocs = fwd_allocs(B, Sq, H, D, Skv, Hkv, q.dtype, with_lse=with_lse,
                            out_f32=out_f32)
        out, lse = [empty(a, q.device) for a in allocs.outputs] + [None] * (
            2 - len(allocs.outputs))
        if out.numel() == 0:
            return (out, lse) if with_lse else out
        strides = (ctypes.c_longlong * 12)(*(
            s for t in (q, k, v, out) for s in t.stride()[:3]))
        common = (_DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), ctypes.addressof(strides))
        masks = (int(bool(causal)), -1 if window is None else window,
                 offset_ptr, offset, 1.0 / math.sqrt(D))
        prefill, decode = self._functions()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            if Sq == 1:
                plan = decode_plan(Skv, B=B, Hkv=Hkv, group=H // Hkv, D=D)
                scratch, tickets = self._decode_buffers(q.device, stream,
                                                        allocs.workspace)
                err = decode(*common, B, Skv, H, Hkv, *masks,
                             scratch.data_ptr(), tickets.data_ptr(),
                             plan.n_splits,
                             None if lse is None else lse.data_ptr(),
                             out.data_ptr() if out_f32 else None, stream)
            else:
                err = prefill(*common, B, Sq, Skv, H, Hkv, *masks,
                              None if lse is None else lse.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"flash attention kernel failed to launch "
                               f"(error {err})")
        self.launches += 1
        if with_lse and Sq == 1:
            self.decode_lse_launches += 1
        return (out, lse) if with_lse else out


class FlashAttentionBwdKernel:
    """The K1 backward kernels' wrapper.  ``launches`` counts kernel
    launches: each call launches :data:`BWD_LAUNCHES_PER_CALL`."""

    _PHASES = ("repro_flash_bwd_preprocess", "repro_flash_bwd_dkdv",
               "repro_flash_bwd_dq")

    def __init__(self) -> None:
        self.launches = 0
        self._fns = None

    def _functions(self):
        if self._fns is None:
            from repro_torch.kernels import build
            lib = build.load(BWD_SOURCE)
            fns = [getattr(lib, name) for name in self._PHASES]
            for fn in fns:
                fn.argtypes = ([ctypes.c_int, ctypes.c_int]
                               + [ctypes.c_void_p] * 11
                               + [ctypes.c_int] * 8
                               + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p])
                fn.restype = ctypes.c_int
            self._fns = fns
        return self._fns

    def __call__(self, q, k, v, out, dout, lse, *, causal: bool = True,
                 window: Optional[int] = None, q_offset: int = 0):
        """(dq, dk, dv) in q's dtype for :func:`flash_attention_plain`'s
        output ``out`` and its gradient ``dout`` (both (B, Sq, H, D), rows
        aligned as q's), from the forward's ``lse`` ((B, H, Sq) f32,
        contiguous).  ``q_offset`` is a host int.  The bf16 kernels' grids
        come from :func:`bwd_plan`; the f32 kernels size their own."""
        what = "flash attention backward kernel"
        B, Sq, H, D, Skv, Hkv = _check_qkv(q, k, v, what)
        if D not in BWD_HEAD_DIMS:
            raise ValueError(f"{what}: head dim {D} (takes {BWD_HEAD_DIMS})")
        if q.dtype == torch.float32 and D == BWD_WIDE \
                and H // Hkv > BWD_F32_WIDE_ROWS:
            raise ValueError(f"{what}: f32 at head dim {D} takes a group of "
                             f"at most {BWD_F32_WIDE_ROWS}, not {H // Hkv}")
        _check_window(window, what)
        if isinstance(q_offset, torch.Tensor):
            raise TypeError(f"{what}: q_offset must be a host int")
        for name, t in (("out", out), ("dout", dout)):
            if t.shape != q.shape or t.dtype != q.dtype \
                    or t.device != q.device or not _aligned(t):
                raise ValueError(f"{what}: {name} must match q's shape, "
                                 f"dtype and device, with aligned rows")
        if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
                or lse.device != q.device or not lse.is_contiguous():
            raise ValueError(f"{what}: lse must be (B, H, Sq) float32, "
                             f"contiguous, on q's device")
        allocs = bwd_allocs(B, Sq, H, D, Skv, Hkv, q.dtype)
        dq, dk, dv = (empty(a, q.device) for a in allocs.outputs)
        if q.numel() == 0 or k.numel() == 0:
            return dq.zero_(), dk.zero_(), dv.zero_()
        delta = empty(allocs.temps[0], q.device)
        strides = (ctypes.c_longlong * 24)(*(
            s for t in (q, k, v, out, dout, dq, dk, dv)
            for s in t.stride()[:3]))
        args = (_DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), ctypes.addressof(strides), B, Sq, Skv, H,
                Hkv, int(bool(causal)), -1 if window is None else window,
                int(q_offset), 1.0 / math.sqrt(D))
        blocks = (0, 0, 0)
        if q.dtype == torch.bfloat16:
            plan = bwd_plan(Sq, Skv, H // Hkv, bool(causal), window,
                            int(q_offset), D)
            blocks = (0, len(plan.dkdv), len(plan.dq))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            for name, fn, n in zip(self._PHASES, self._functions(), blocks):
                err = fn(*args, n, stream)
                if err != 0:
                    raise RuntimeError(f"{what}: {name} failed to launch "
                                       f"(error {err})")
                self.launches += 1
        return dq, dk, dv


#: The process's one K1 wrapper; ``flash_attention_cuda.launches`` is the
#: count a run reads to show that its path went through the kernels.
flash_attention_cuda = FlashAttentionKernel()
#: The process's one K1 backward wrapper, counted the same way.
flash_attention_bwd_cuda = FlashAttentionBwdKernel()
