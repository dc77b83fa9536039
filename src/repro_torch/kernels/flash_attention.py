"""Flash attention: the K1 Hopper kernel's wrapper and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the JAX package's Pallas
TPU kernel ``flash_attention_kernel`` (``repro/kernels/flash_attention.py``)
and covers what the model path needs beyond it: the model's (B, S, H, D)
layout, a query offset that lives in device memory (decode), the causal
and window masks and a ragged Skv.  See the source's header for what bounds
it on an H100 and what its design does about that.

:func:`flash_attention_plain` is the port of ``repro.models.layers.
flash_attention``: an online softmax scanned over kv chunks.  It is what
runs for CPU tensors, and the version the kernel is held against on the
card.  :data:`flash_attention_cuda` launches the kernel on CUDA tensors and
raises on anything it does not take; it never falls back.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

SOURCE = "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 64   # a block's 64 rows hold at least one query position
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


def _aligned(t: torch.Tensor) -> bool:
    """Head dim contiguous, every row start on a 16-byte boundary."""
    item = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all((s * item) % 16 == 0 for s in t.stride()[:-1]))


class FlashAttentionKernel:
    """The K1 kernel's wrapper.  ``launches`` counts kernel launches."""

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            from repro_torch.kernels import build
            fn = build.load(SOURCE).repro_flash_attention_fwd
            fn.argtypes = ([ctypes.c_int, ctypes.c_int]
                           + [ctypes.c_void_p] * 5
                           + [ctypes.c_int] * 7
                           + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, q, k, v, *, causal: bool = True,
                 window: Optional[int] = None, q_offset: QOffset = 0):
        """Same contract as :func:`flash_attention_plain`, on CUDA tensors
        of float32 or bfloat16 with head dim in :data:`HEAD_DIMS`."""
        if q.device.type != "cuda":
            raise ValueError(f"flash attention kernel: q is on {q.device}, "
                             f"the kernel runs on CUDA tensors only")
        if k.device != q.device or v.device != q.device:
            raise ValueError("flash attention kernel: q, k, v on different "
                             "devices")
        if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
                or v.dtype != q.dtype:
            raise TypeError(f"flash attention kernel: dtypes "
                            f"{q.dtype}/{k.dtype}/{v.dtype}; needs one of "
                            f"{sorted(map(str, _DTYPE_CODE))} for all three")
        if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
            raise ValueError(f"flash attention kernel: shapes {tuple(q.shape)}"
                             f" {tuple(k.shape)} {tuple(v.shape)}")
        B, Sq, H, D = q.shape
        Bk, Skv, Hkv, Dk = k.shape
        if Bk != B or Dk != D or Hkv == 0 or H % Hkv:
            raise ValueError(f"flash attention kernel: q {tuple(q.shape)} "
                             f"does not match k/v {tuple(k.shape)}")
        if D not in HEAD_DIMS or H // Hkv > MAX_GROUP:
            raise ValueError(f"flash attention kernel: head dim {D} (takes "
                             f"{HEAD_DIMS}), group {H // Hkv} (at most "
                             f"{MAX_GROUP})")
        if not all(map(_aligned, (q, k, v))):
            raise ValueError("flash attention kernel: q, k, v need a "
                             "contiguous head dim and 16-byte aligned rows")
        if window is not None and not isinstance(window, int):
            raise TypeError("flash attention kernel: window must be an int "
                            "or None")
        if window is not None and window < 0:
            raise ValueError(f"flash attention kernel: window {window} < 0")
        offset_ptr, offset = None, 0
        if isinstance(q_offset, torch.Tensor):
            if q_offset.device != q.device or q_offset.dtype != torch.int32 \
                    or q_offset.numel() != 1 or not q_offset.is_contiguous():
                raise ValueError("flash attention kernel: a tensor q_offset "
                                 "must be one int32 on q's device")
            offset_ptr = q_offset.data_ptr()
        else:
            offset = int(q_offset)
        out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
        if out.numel() == 0:
            return out
        strides = (ctypes.c_longlong * 12)(*(
            s for t in (q, k, v, out) for s in t.stride()[:3]))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = self._function()(
                _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), ctypes.addressof(strides),
                B, Sq, Skv, H, Hkv, int(bool(causal)),
                -1 if window is None else window, offset_ptr, offset,
                1.0 / math.sqrt(D), stream)
        if err != 0:
            raise RuntimeError(f"flash attention kernel failed to launch "
                               f"(error {err})")
        self.launches += 1
        return out


#: The process's one K1 wrapper; ``flash_attention_cuda.launches`` is the
#: count a run reads to show that its path went through the kernel.
flash_attention_cuda = FlashAttentionKernel()
