"""The plain reference of the benchmarked model: the port's Mamba1 (ssm)
language model, written from its equations in plain PyTorch, float32,
with no kernel, cache or batching of the port.

It imports nothing of the program.  It reads the parameter tree the
harness made (the port's layout, layers stacked on a leading axis) and
the numbers of a configuration file's ``run`` section.  Every product of
activations and weights goes through a precision ``prec``
(``reference.quant``): float32 for the reference, both operands rounded
to float8 for the control.

The recurrence is scanned in chunks: within a chunk a loop over its
steps runs all chunks at once, twice (first from a zero state to find
each chunk's end state, then from the state that enters it), and the
state entering each chunk is carried across the chunks in between.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.quant import F32, Precision

Params = Dict[str, object]


def no_tf32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, w, eps):
    """x / rms(x) · (1 + w): the norm weight is stored as an offset from 1."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + w)


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_conv(x, w, b):
    """Depthwise causal convolution over the sequence; x (B, S, C), w (C,
    K) whose tap 0 weighs the current position and tap K-1 the oldest."""
    K = w.shape[1]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, K - 1 - j:K - 1 - j + S] * w[:, j] for j in range(K)) + b


def _forward_states(a, b, h_in):
    """h_t = a_t ⊙ h_{t-1} + b_t along dim 0 (c steps) of (c, M, ...) from
    ``h_in`` (M, ...); returns every h_t (c, M, ...)."""
    hs = torch.empty_like(b)
    h = h_in
    for t in range(a.shape[0]):
        h = torch.addcmul(b[t], a[t], h)
        hs[t] = h
    return hs


def _chunked(a, b, nc):
    """The recurrence over a sequence cut into ``nc`` chunks laid out as
    (c, Bsz·nc, ...): each chunk from a zero state, the state entering each
    chunk carried across the chunks, then each chunk again from it.
    Returns (every h_t, the states entering the chunks)."""
    c, M = a.shape[:2]
    Bsz = M // nc
    ends = _forward_states(a, b, torch.zeros_like(b[0]))[-1]
    through = a.prod(0)                     # each chunk's decay, end to end
    ends = ends.reshape(Bsz, nc, *ends.shape[1:])
    through = through.reshape(Bsz, nc, *through.shape[1:])
    carry = torch.zeros_like(ends[:, 0])
    entering = []
    for k in range(nc):
        entering.append(carry)
        carry = through[:, k] * carry + ends[:, k]
    h0 = torch.stack(entering, 1).reshape(M, *ends.shape[2:])
    return _forward_states(a, b, h0), h0


def _layout(t, c):
    """(Bsz, S, ...) → (c, Bsz·nc, ...), S padded with zeros to nc·c."""
    Bsz, S = t.shape[:2]
    pad = (-S) % c
    if pad:
        t = torch.cat([t, t.new_zeros((Bsz, pad) + t.shape[2:])], 1)
    nc = t.shape[1] // c
    return t.reshape((Bsz * nc, c) + t.shape[2:]).transpose(0, 1), nc


def _unlayout(t, Bsz, S):
    """(c, Bsz·nc, ...) → (Bsz, S, ...)."""
    c, M = t.shape[:2]
    return t.transpose(0, 1).reshape((Bsz, M // Bsz * c) + t.shape[2:])[:, :S]


class Mamba1Scan(torch.autograd.Function):
    """h_t = exp(dt_t·A) ⊙ h_{t-1} + dt_t·x_t ⊗ B_t from h = 0 and
    y_t = Σ_n h_t[:, n]·C_t[n], in float32, one block of channels at a time
    (they never mix); the backward runs the recurrence of the state's
    gradient, g_t = dy_t ⊗ C_t + exp(dt_{t+1}·A) ⊙ g_{t+1}, the same way in
    reverse, and recomputes the states from those entering each chunk."""

    @staticmethod
    def forward(ctx, x, dt, Bm, Cm, A, chunk, d_block):
        Bsz, S, d = x.shape
        c = min(chunk, S)
        ctx.chunk, ctx.d_block = chunk, d_block
        Bl, nc = _layout(Bm, c)
        Cl, _ = _layout(Cm, c)
        ys, h0s = [], []
        for d0 in range(0, d, d_block):
            blk = slice(d0, d0 + d_block)
            xl, _ = _layout(x[..., blk], c)
            dtl, _ = _layout(dt[..., blk], c)
            a = torch.exp(dtl[..., None] * A[blk])
            b = (dtl * xl)[..., None] * Bl[:, :, None, :]
            hs, h0 = _chunked(a, b, nc)
            ys.append(_unlayout(torch.einsum("cmdn,cmn->cmd", hs, Cl),
                                Bsz, S))
            h0s.append(h0)
        ctx.save_for_backward(x, dt, Bm, Cm, A, *h0s)
        return torch.cat(ys, -1)

    @staticmethod
    def backward(ctx, dy):
        x, dt, Bm, Cm, A, *h0s = ctx.saved_tensors
        Bsz, S, d = x.shape
        c, d_block = min(ctx.chunk, S), ctx.d_block
        Bl, nc = _layout(Bm, c)
        Cl, _ = _layout(Cm, c)
        dx, ddt, dA = torch.empty_like(x), torch.empty_like(dt),             torch.empty_like(A)
        dB = torch.zeros_like(Bl)
        dC = torch.zeros_like(Cl)
        for i, d0 in enumerate(range(0, d, d_block)):
            blk = slice(d0, d0 + d_block)
            xl, _ = _layout(x[..., blk], c)
            dtl, _ = _layout(dt[..., blk], c)
            dyl, _ = _layout(dy[..., blk].contiguous(), c)
            a = torch.exp(dtl[..., None] * A[blk])
            b = (dtl * xl)[..., None] * Bl[:, :, None, :]
            hs = _forward_states(a, b, h0s[i])
            dC += torch.einsum("cmd,cmdn->cmn", dyl, hs)
            # h_{t-1}: the state entering each step
            prev = torch.cat([h0s[i][None], hs[:-1]], 0)
            del hs, b
            # the state's gradient, run backwards: decay a_{t+1}, input
            # e_t = dy_t ⊗ C_t; a_{t+1} is zero past each chunk's end
            e = dyl[..., None] * Cl[:, :, None, :]
            a_next = torch.cat([a[1:], torch.zeros_like(a[:1])], 0)
            g_loc = _forward_states(a_next.flip(0), e.flip(0),
                                    torch.zeros_like(e[0])).flip(0)
            # carry across chunks, from the last: G into chunk k from k+1
            P = _shifted_suffix(a_next)             # a_{t+1} … a_{c-1}
            starts = g_loc[0].reshape(Bsz, nc, *g_loc.shape[2:])
            a_first = a[0].reshape(Bsz, nc, *a.shape[2:])
            through = P[0].reshape(Bsz, nc, *a.shape[2:])
            G = torch.zeros_like(starts[:, 0])
            into = [None] * nc
            for k in range(nc - 1, -1, -1):
                into[k] = G
                G = a_first[:, k] * (starts[:, k] + through[:, k] * G)
            G = torch.stack(into, 1).reshape(g_loc.shape[1:])
            g = torch.addcmul(g_loc, P, G)
            del g_loc, e, P
            da = g * prev * a                       # dL/d(dt·A) per state
            del prev
            dtA = torch.einsum("cmdn,dn->cmd", da, A[blk])
            gB = torch.einsum("cmdn,cmn->cmd", g, Bl)
            dB += torch.einsum("cmdn,cmd->cmn", g, dtl * xl)
            dA[blk] = torch.einsum("cmdn,cmd->dn", da, dtl)
            dx[..., blk] = _unlayout(gB * dtl, Bsz, S)
            ddt[..., blk] = _unlayout(dtA + gB * xl, Bsz, S)
        return (dx, ddt, _unlayout(dB, Bsz, S), _unlayout(dC, Bsz, S), dA,
                None, None)


def _shifted_suffix(a_next):
    """P_t = a_{t+1} ⊙ … ⊙ a_{c-1}, the decay from step t to the chunk's
    end (1 at the last step), as a_next holds a_{t+1} at t."""
    c = a_next.shape[0]
    out = torch.ones_like(a_next)
    for t in range(c - 2, -1, -1):
        out[t] = out[t + 1] * a_next[t]
    return out


def mamba1_scan(x, dt, Bm, Cm, A, chunk: int = 64, d_block: int = 1024):
    """The Mamba1 recurrence; x, dt (B, S, d), Bm, Cm (B, S, N), A (d, N)
    → y (B, S, d) (see :class:`Mamba1Scan`): ``chunk`` steps a chunk,
    ``d_block`` channels at a time."""
    return Mamba1Scan.apply(x, dt, Bm, Cm, A, chunk, d_block)


def mamba1(p, u, run, prec: Precision):
    R, N = run["dt_rank"], run["ssm_state"]
    x = prec.mm(u, p["in_x"])
    z = prec.mm(u, p["in_z"])
    x = F.silu(causal_conv(x, prec.w(p["conv_w"]), p["conv_b"]))
    dbc = prec.mm(x, p["x_proj"])
    dt = softplus(prec.mm(dbc[..., :R], p["dt_proj"]) + p["dt_bias"])
    Bm, Cm = dbc[..., R:R + N], dbc[..., R + N:]
    A = -torch.exp(p["A_log"])
    y = mamba1_scan(x, dt, Bm, Cm, A)
    y = (y + p["D"] * x) * F.silu(z)
    return prec.mm(y, p["out_proj"])


def layer_view(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked layer leaves."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params["layers"])


def _ssm_layer(lp, x, run, prec):
    return x + mamba1(lp["ssm"], rms_norm(x, lp["ln1"], run["norm_eps"]),
                      run, prec)


def hidden(params: Params, tokens, run, prec: Precision = F32,
           remat: bool = False):
    """Token ids (B, S) → the final normed hidden states (B, S, d), f32.
    ``remat`` runs each layer under ``torch.utils.checkpoint`` (a training
    reference keeps one layer's internals at a time)."""
    x = prec.w(params["embed"])[tokens.long()]
    for i in range(run["n_layers"]):
        lp = layer_view(params, i)
        if remat:
            x = checkpoint(_ssm_layer, lp, x, run, prec,
                           use_reentrant=False)
        else:
            x = _ssm_layer(lp, x, run, prec)
    return rms_norm(x, params["final_norm"], run["norm_eps"])


def logits(params: Params, h, prec: Precision = F32):
    """The tied head: h (..., d) → logits (..., vocab)."""
    return prec.mm(h, params["embed"].T)


def loss(params: Params, tokens, labels, run, prec: Precision = F32,
         head_block: int = 1024):
    """Sum over the rows' tokens of the next-token cross entropy (the caller
    divides by the tokens of the whole batch), with remat per layer and
    the head in blocks of positions."""
    h = hidden(params, tokens, run, prec, remat=True)
    total = h.new_zeros(())
    S = h.shape[1]
    for s0 in range(0, S, head_block):
        total = total + checkpoint(_head_loss, params["embed"],
                                   h[:, s0:s0 + head_block],
                                   labels[:, s0:s0 + head_block], prec,
                                   use_reentrant=False)
    return total


def _head_loss(embed, h, y, prec):
    lg = prec.mm(h, embed.T)
    return torch.sum(torch.logsumexp(lg, -1)
                     - torch.gather(lg, -1, y.long()[..., None])[..., 0])


def last_logits(params: Params, tokens, run, prec: Precision = F32):
    """The logits after a prompt's last token (B, vocab)."""
    with torch.no_grad():
        h = hidden(params, tokens, run, prec)
        return logits(params, h[:, -1], prec)


__all__ = ["hidden", "logits", "loss", "last_logits", "no_tf32"]
