"""Mamba1 (selective scan) and Mamba2 (SSD) blocks: the port of
``repro/models/ssm.py``.

Mamba1's prefill and training block has the reference's two forms, chosen
by its ``fused`` argument as in the reference.  The fused form, the
default, hands x, dt, B, C and A to :func:`repro_torch.kernels.ops.
mamba1_scan`: the fused K2 kernel on the card (with its backward kernel
under autograd), which builds decay = exp(dt·A) and inc = dt·x·B in
registers; its plain torch version on the CPU.  ``fused=False`` builds
decay and inc in f32, (B, S, d_inner, N) each, and hands them to
:func:`repro_torch.kernels.ops.ssm_scan`, the unfused K2 kernel (forward
only).  The reference reads its default from an environment variable; the
port has only the argument.

Mamba2's block is the SSD chunked form: per chunk an attention-like
masked matmul, chunk summaries, and a recurrence over the chunks that
carries the (B, H, N, P) state.  It is einsums and a loop over chunks in
f32, as in the reference, which has no Pallas kernel for it; the chunk
length (128, the reference's default for Mamba2) is an argument.

Decode is a closed-form update of one token in both blocks and reaches no
kernel.  Under a mesh the reference's sharding constraints stand at its
points: x and z sharded on d_inner over the model axis (the scan runs on
each rank's channels), Mamba2's heads likewise; on one device they are
the identity and are left out.

Mamba1's prefill and training block opens a span of the compute path's
trace (:func:`repro_torch.core.trace.compute`) at each step:
``ssm.in_proj``, ``ssm.conv`` (the causal conv and its SiLU),
``ssm.x_proj``, ``ssm.dt`` (dt_proj, its bias and the softplus),
``ssm.gate`` (the skip term D·x and the SiLU gate by z) and
``ssm.out_proj``; the fused scan between them is ``kernel.k2_fwd``
(:mod:`repro_torch.kernels.ops`).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core import trace as _trace
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import decay_inc
from repro_torch.models.layers import _init, init_rms_norm, rms_norm

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
    with _trace.compute("in_proj", "ssm"):
        x = sh.constrain(u @ p["in_x"], "batch", None, "model")
        z = sh.constrain(u @ p["in_z"], "batch", None, "model")
    with _trace.compute("conv", "ssm"):
        x = F.silu(causal_conv1d(x, p["conv_w"], p["conv_b"]))
    # dt, B and C are sums over every channel; dt goes back to the
    # channels' shards
    with _trace.compute("x_proj", "ssm"):
        dbc = sh.constrain(x @ p["x_proj"], "batch", None, None)
    dt = dbc[..., :dt_rank]
    Bs = dbc[..., dt_rank:dt_rank + d_state]
    Cs = dbc[..., dt_rank + d_state:]
    with _trace.compute("dt", "ssm"):
        dt = sh.constrain(_softplus(dt @ p["dt_proj"] + p["dt_bias"]),
                          "batch", None, "model")
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
    with _trace.compute("gate", "ssm"):
        y = y.to(u.dtype) + p["D"] * x
        y = y * F.silu(z)
    with _trace.compute("out_proj", "ssm"):
        return y @ p["out_proj"]


def mamba1_decode(p: Params, u, state, *, d_state: int):
    """Single token; u: (B, 1, d); state = {"h": (B,di,N) f32, "conv":
    (B,K-1,di)}.  Returns (out (B, 1, d), the new state)."""
    dt_rank = p["dt_proj"].shape[0]
    x = sh.constrain(u[:, 0] @ p["in_x"], "batch", "model")
    z = sh.constrain(u[:, 0] @ p["in_z"], "batch", "model")
    x, conv = conv_decode(x, state["conv"].to(x.dtype), p["conv_w"],
                          p["conv_b"])
    x = F.silu(x).to(u.dtype)
    # dt, B and C are sums over every channel; dt goes back to the
    # channels' shards, as the prefill's gates leave it
    dbc = sh.constrain(x @ p["x_proj"], "batch", None)
    dt = sh.constrain(_softplus(dbc[..., :dt_rank] @ p["dt_proj"]
                                + p["dt_bias"]), "batch", "model")
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


# ----------------------------------------------------------------- mamba 2 --
def init_mamba2(gen: torch.Generator, d_model: int, d_state: int,
                d_conv: int, expand: int, head_dim: int, *, stack: int = 0,
                dtype=torch.float32) -> Params:
    """The reference's Mamba2 parameters and distributions, drawn from
    ``gen`` as :func:`init_mamba1` draws its own."""
    di = expand * d_model
    H = di // head_dim
    dev = gen.device
    kw = dict(stack=stack, dtype=dtype)
    lead = (stack,) if stack else ()
    return {
        "in_z": _init(gen, (d_model, di), **kw),
        "in_x": _init(gen, (d_model, di), **kw),
        "in_B": _init(gen, (d_model, d_state), **kw),
        "in_C": _init(gen, (d_model, d_state), **kw),
        "in_dt": _init(gen, (d_model, H), **kw),
        "conv_w": _init(gen, (di, d_conv), scale=1.0 / math.sqrt(d_conv),
                        **kw),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "A_log": torch.zeros(lead + (H,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros(lead + (H,), dtype=dtype, device=dev),
        "D": torch.ones(lead + (H,), dtype=dtype, device=dev),
        "norm": init_rms_norm(di, device=dev, **kw),
        "out_proj": _init(gen, (di, d_model), **kw),
    }


def _m2_split(p, u):
    """The input projections: z, x (before the conv), B, C and dt."""
    roles = ("batch", None, "model") if u.ndim == 3 else ("batch", "model")
    z = sh.constrain(u @ p["in_z"], *roles)
    x = sh.constrain(u @ p["in_x"], *roles)
    Bs = u @ p["in_B"]
    Cs = u @ p["in_C"]
    dt = _softplus(u @ p["in_dt"] + p["dt_bias"])
    return z, x, Bs, Cs, dt


def mamba2_block(p: Params, u, *, d_state: int, head_dim: int,
                 chunk: int = 128, eps: float = 1e-6):
    """SSD chunked forward; u: (B, S, d) → (B, S, d).

    Y_t = C_t · (exp(ΣL) R_chunk + Σ_{j≤t} exp(L_t − L_j) B_j (dt_j x_j))
          + D ⊙ x_t, in f32; S must be a multiple of ``chunk`` (or at most
    ``chunk``).  The intra-chunk decay is exp of the masked gap (−inf
    above the diagonal), the reference's where(tri, exp(gap), 0) without
    the overflow its upper triangle may reach.
    """
    B, S, _ = u.shape
    di = p["out_proj"].shape[0]
    H = di // head_dim
    chunk = min(chunk, S)
    nc = S // chunk
    assert nc * chunk == S, f"S={S} not divisible by chunk={chunk}"
    z, x, Bs, Cs, dt = _m2_split(p, u)
    x = F.silu(causal_conv1d(x, p["conv_w"], p["conv_b"]))
    xh = sh.constrain(x.reshape(B, nc, chunk, H, head_dim).float(),
                      "batch", None, None, "model", None)
    Bc = Bs.reshape(B, nc, chunk, d_state).float()
    Cc = Cs.reshape(B, nc, chunk, d_state).float()
    dtc = dt.reshape(B, nc, chunk, H).float()
    A = -torch.exp(p["A_log"].float())                       # (H,)
    cumL = torch.cumsum(dtc * A, dim=2)                      # inclusive, ≤ 0
    xdt = xh * dtc[..., None]                                # (B,nc,c,H,P)

    # intra-chunk: masked decay-weighted attention-like matmul
    scores = torch.einsum("bnik,bnjk->bnij", Cc, Bc)         # (B,nc,c,c)
    gap = cumL[:, :, :, None, :] - cumL[:, :, None, :, :]    # (B,nc,i,j,H)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=u.device).tril()[None, None, :, :, None]
    M = torch.exp(torch.where(tri, gap, -math.inf))
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", scores[..., None] * M, xdt)

    # chunk summaries and the inter-chunk recurrence
    decay_to_end = torch.exp(cumL[:, :, -1:, :] - cumL)      # (B,nc,c,H)
    S_n = torch.einsum("bnjh,bnjk,bnjhp->bnhkp", decay_to_end, Bc, xdt)
    a_tot = torch.exp(cumL[:, :, -1, :])[..., None, None]    # (B,nc,H,1,1)
    R = torch.zeros((B, H, d_state, head_dim), dtype=torch.float32,
                    device=u.device)
    pre = []
    for n in range(nc):                 # the state before each chunk
        pre.append(R)
        R = a_tot[:, n] * R + S_n[:, n]
    R_stack = torch.stack(pre, dim=1)                        # (B,nc,H,N,P)
    y_inter = torch.einsum("bnik,bnih,bnhkp->bnihp", Cc, torch.exp(cumL),
                           R_stack)

    y = (y_intra + y_inter).reshape(B, S, H, head_dim)
    y = y + xh.reshape(B, S, H, head_dim) * p["D"].float()[..., None]
    y = y.reshape(B, S, di).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], eps)
    return y @ p["out_proj"]


def mamba2_decode(p: Params, u, state, *, d_state: int, head_dim: int,
                  eps: float = 1e-6):
    """Single token; u: (B, 1, d); state = {"h": (B,H,N,P) f32, "conv":
    (B,K-1,di)}.  Returns (out (B, 1, d), the new state)."""
    B = u.shape[0]
    di = p["out_proj"].shape[0]
    H = di // head_dim
    z, x, Bs, Cs, dt = _m2_split(p, u[:, 0])
    x, conv = conv_decode(x, state["conv"].to(x.dtype), p["conv_w"],
                          p["conv_b"])
    x = F.silu(x)
    xh = x.reshape(B, H, head_dim).float()
    dtf = dt.float()
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dtf * A)                                   # (B,H)
    inc = torch.einsum("bk,bhp->bhkp", Bs.float(), xh * dtf[..., None])
    h = a[..., None, None] * state["h"] + inc
    y = torch.einsum("bk,bhkp->bhp", Cs.float(), h)
    y = y + xh * p["D"].float()[..., None]
    y = y.reshape(B, di).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], eps)
    return ((y @ p["out_proj"])[:, None, :].to(u.dtype),
            {"h": h, "conv": conv.to(state["conv"].dtype)})


# ------------------------------------------------------ family dispatch --
#: The SSD chunk of the Mamba2 block, the reference's default for Mamba2
#: (Mamba1 takes 1024).
MAMBA2_CHUNK = 128


def init_ssm(gen: torch.Generator, cfg, *, stack: int = 0,
             dtype=torch.float32) -> Params:
    if cfg.ssm_type == "mamba1":
        return init_mamba1(gen, cfg.d_model, cfg.ssm_state, cfg.ssm_conv,
                           cfg.ssm_expand, stack=stack, dtype=dtype)
    return init_mamba2(gen, cfg.d_model, cfg.ssm_state, cfg.ssm_conv,
                       cfg.ssm_expand, cfg.ssm_head_dim, stack=stack,
                       dtype=dtype)


@sh.under_mesh
def ssm_block(p: Params, u, cfg, chunk: int = 0):
    """The config's block; ``chunk`` 0 takes its type's default (1024 for
    Mamba1, :data:`MAMBA2_CHUNK` for Mamba2)."""
    if cfg.ssm_type == "mamba1":
        return mamba1_block(p, u, d_state=cfg.ssm_state, chunk=chunk or 1024)
    return mamba2_block(p, u, d_state=cfg.ssm_state,
                        head_dim=cfg.ssm_head_dim,
                        chunk=chunk or MAMBA2_CHUNK, eps=cfg.norm_eps)


@sh.under_mesh
def ssm_decode(p: Params, u, state, cfg):
    if cfg.ssm_type == "mamba1":
        return mamba1_decode(p, u, state, d_state=cfg.ssm_state)
    return mamba2_decode(p, u, state, d_state=cfg.ssm_state,
                         head_dim=cfg.ssm_head_dim, eps=cfg.norm_eps)


def init_ssm_state(cfg, batch: int, dtype=torch.float32, *, stack: int = 0,
                   device=None) -> Params:
    """Zero decode state: h in f32, (B, di, N) for Mamba1 and (B, H, N, P)
    for Mamba2, and the conv window (B, K-1, di) in ``dtype``, with a
    leading axis of ``stack`` layers if > 0."""
    lead = (stack,) if stack else ()
    di = cfg.d_inner
    h = ((batch, di, cfg.ssm_state) if cfg.ssm_type == "mamba1" else
         (batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim))
    return {"h": torch.zeros(lead + h, dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, di),
                                dtype=dtype, device=device)}
