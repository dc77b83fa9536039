"""Selective scan: the K2 Hopper kernel's wrapper and its plain version.

The kernel (``csrc/ssm_scan.cu``) replaces the JAX package's Pallas TPU
kernel ``ssm_scan_kernel`` (``repro/kernels/ssm_scan.py``): the diagonal
linear recurrence of Mamba1,

    h_t = decay_t ⊙ h_{t-1} + inc_t        (B, d, N) per step, h_0 = 0
    y_t = Σ_n h_t[..., n] · C_t[n]

with decay, inc (B, S, d, N) and C (B, S, N) read as f32 and y (B, S, d)
f32.  The TPU kernel's tiling (``chunk``, ``d_block``) has no counterpart:
the CUDA kernel takes any S and any d.  See the source's header for what
bounds it on an H100 and what its design does about that.

:func:`ssm_scan_plain` is the same recurrence as a loop over S in torch.
It is what runs for CPU tensors, and the version the kernel is held
against on the card.  :data:`ssm_scan_cuda` launches the kernel on CUDA
tensors and raises on anything it does not take; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.runtime import needs_grad

SOURCE = "ssm_scan.cu"
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
        y = torch.empty((B, S, d), dtype=torch.float32, device=decay.device)
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
