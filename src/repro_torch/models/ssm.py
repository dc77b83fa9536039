"""Mamba1 (selective scan) blocks: the port of the Mamba1 half of
``repro/models/ssm.py``.

The prefill and training block has the reference's two forms, chosen by
its ``fused`` argument as in the reference.  The fused form, the default,
hands x, dt, B, C and A to :func:`repro_torch.kernels.ops.mamba1_scan`:
the fused K2 kernel on the card (with its backward kernel under
autograd), which builds decay = exp(dt·A) and inc = dt·x·B in registers;
its plain torch version on the CPU.  ``fused=False`` builds decay and inc
in f32, (B, S, d_inner, N) each, and hands them to
:func:`repro_torch.kernels.ops.ssm_scan`, the unfused K2 kernel (forward
only).  The reference reads its default from an environment variable; the
port has only the argument.  Decode is a closed-form update of one token
and reaches no kernel.

The reference's sharding constraints are the identity on one device and
are left out.  Mamba2 (SSD) is not ported: its configurations raise
:class:`NotImplementedError`.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import decay_inc
from repro_torch.models.layers import _init

Params = Dict[str, Any]


def _softplus(x):
    """``jax.nn.softplus``, log(1 + eˣ), in f32 and for every x (torch's
    ``F.softplus`` returns x itself above its threshold of 20)."""
    xf = x.float()
    return torch.logaddexp(xf, xf.new_zeros(())).to(x.dtype)


# ----------------------------------------------------------------- conv1d --
def causal_conv1d(x, w, b):
    """Depthwise causal conv; x: (B, S, C), w: (C, K), b: (C,).  Tap
    ``w[:, 0]`` weighs the current position, ``w[:, K-1]`` the oldest."""
    K = w.shape[1]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, j:j + S, :] * w[:, K - 1 - j] for j in range(K))
    return out + b


def conv_decode(x, conv_state, w, b):
    """Single-token conv; x: (B, C); conv_state: (B, K-1, C), oldest
    first.  Returns (out, the next conv_state)."""
    window = torch.cat([conv_state, x[:, None, :]], dim=1)  # (B, K, C)
    out = torch.einsum("bkc,ck->bc", window, w.flip(1)) + b
    return out, window[:, 1:, :]


# ----------------------------------------------------------------- mamba 1 --
def init_mamba1(gen: torch.Generator, d_model: int, d_state: int,
                d_conv: int, expand: int, *, stack: int = 0,
                dtype=torch.float32) -> Params:
    """The reference's Mamba1 parameters and distributions, drawn from
    ``gen`` (``stack > 0``: that many layers along a leading axis), each
    leaf cast to ``dtype`` as soon as it is drawn."""
    di = expand * d_model
    dt_rank = max(1, d_model // 16)
    dev = gen.device
    kw = dict(stack=stack, dtype=dtype)
    lead = (stack,) if stack else ()
    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                   device=dev))
    return {
        "in_x": _init(gen, (d_model, di), **kw),
        "in_z": _init(gen, (d_model, di), **kw),
        "conv_w": _init(gen, (di, d_conv), scale=1.0 / math.sqrt(d_conv),
                        **kw),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "x_proj": _init(gen, (di, dt_rank + 2 * d_state), **kw),
        "dt_proj": _init(gen, (dt_rank, di), scale=1.0, **kw),
        "dt_bias": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "A_log": a_log.expand(lead + (di, d_state)).contiguous().to(dtype),
        "D": torch.ones(lead + (di,), dtype=dtype, device=dev),
        "out_proj": _init(gen, (di, d_model), **kw),
    }


def _m1_gates(p, u, dt_rank, d_state):
    """Shared projections: returns x (conv'd), z, dt, B, C."""
    x = u @ p["in_x"]
    z = u @ p["in_z"]
    x = F.silu(causal_conv1d(x, p["conv_w"], p["conv_b"]))
    dbc = x @ p["x_proj"]
    dt = dbc[..., :dt_rank]
    Bs = dbc[..., dt_rank:dt_rank + d_state]
    Cs = dbc[..., dt_rank + d_state:]
    dt = _softplus(dt @ p["dt_proj"] + p["dt_bias"])
    return x, z, dt, Bs, Cs


def mamba1_block(p: Params, u, *, d_state: int, chunk: int = 256,
                 fused: bool = True):
    """Prefill and training forward; u: (B, S, d_model) → (B, S, d_model).
    ``fused`` (the reference's default) scans through
    :func:`ops.mamba1_scan`; ``fused=False`` builds decay and inc in full
    and scans them through :func:`ops.ssm_scan`.  ``chunk`` sizes the
    plain versions' work."""
    dt_rank = p["dt_proj"].shape[0]
    x, z, dt, Bs, Cs = _m1_gates(p, u, dt_rank, d_state)
    A = -torch.exp(p["A_log"].float())                       # (di, N)
    chunk = min(chunk, u.shape[1])
    if fused:
        y = ops.mamba1_scan(x, dt, Bs, Cs, A, chunk=chunk)
    else:
        decay, inc = decay_inc(dt, x, Bs, A)                 # (B,S,di,N)
        # Cs is a strided slice of dbc; the kernel reads contiguous rows
        y = ops.ssm_scan(decay, inc, Cs.float().contiguous(), chunk=chunk)
        del decay, inc   # the two largest tensors of the layer
    y = y.to(u.dtype) + p["D"] * x
    y = y * F.silu(z)
    return y @ p["out_proj"]


def mamba1_decode(p: Params, u, state, *, d_state: int):
    """Single token; u: (B, 1, d); state = {"h": (B,di,N) f32, "conv":
    (B,K-1,di)}.  Returns (out (B, 1, d), the new state)."""
    dt_rank = p["dt_proj"].shape[0]
    x = u[:, 0] @ p["in_x"]
    z = u[:, 0] @ p["in_z"]
    x, conv = conv_decode(x, state["conv"].to(x.dtype), p["conv_w"],
                          p["conv_b"])
    x = F.silu(x).to(u.dtype)
    dbc = x @ p["x_proj"]
    dt = _softplus(dbc[..., :dt_rank] @ p["dt_proj"] + p["dt_bias"])
    Bs = dbc[..., dt_rank:dt_rank + d_state]
    Cs = dbc[..., dt_rank + d_state:]
    A = -torch.exp(p["A_log"].float())
    decay, inc = decay_inc(dt, x, Bs, A)                     # (B,di,N)
    h = decay * state["h"] + inc
    y = torch.einsum("bdn,bn->bd", h, Cs.float()).to(u.dtype)
    y = y + p["D"] * x
    y = y * F.silu(z)
    out = (y @ p["out_proj"])[:, None, :].to(u.dtype)
    return out, {"h": h, "conv": conv.to(state["conv"].dtype)}


# ------------------------------------------------------ family dispatch --
def _check_mamba1(cfg) -> None:
    if cfg.ssm_type != "mamba1":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.ssm_type!r} SSM block is not ported yet "
            f"(mamba1 only)")


def init_ssm(gen: torch.Generator, cfg, *, stack: int = 0,
             dtype=torch.float32) -> Params:
    _check_mamba1(cfg)
    return init_mamba1(gen, cfg.d_model, cfg.ssm_state, cfg.ssm_conv,
                       cfg.ssm_expand, stack=stack, dtype=dtype)


def ssm_block(p: Params, u, cfg, chunk: int = 1024):
    _check_mamba1(cfg)
    return mamba1_block(p, u, d_state=cfg.ssm_state, chunk=chunk)


def ssm_decode(p: Params, u, state, cfg):
    _check_mamba1(cfg)
    return mamba1_decode(p, u, state, d_state=cfg.ssm_state)


def init_ssm_state(cfg, batch: int, dtype=torch.float32, *, stack: int = 0,
                   device=None) -> Params:
    """Zero decode state: h (B, di, N) in f32 and the conv window (B, K-1,
    di) in ``dtype``, with a leading axis of ``stack`` layers if > 0."""
    _check_mamba1(cfg)
    lead = (stack,) if stack else ()
    di = cfg.d_inner
    return {"h": torch.zeros(lead + (batch, di, cfg.ssm_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, di),
                                dtype=dtype, device=device)}
