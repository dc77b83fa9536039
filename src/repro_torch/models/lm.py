"""The language model: init, prefill forward, cached decode and the
training loss — the port of ``repro/models/lm.py``: the dense, moe, ssm
(Mamba1 and Mamba2), hybrid, encdec and vlm families.

Parameters are the reference's nested dict with layers *stacked* on a
leading axis (``params["layers"]["attn"]["wq"]`` is ``(n_layers, d_model,
heads, head_dim)``), so one scda checkpoint loads in both packages.  The
layer loop is a Python loop over views of the stacked tensors.

The reference casts every layer's f32 weights to the compute dtype inside
each step; at full width that would rewrite the whole model once per
decoded token.  For serving, the weights are cast once
(:func:`cast_params`) when they are loaded, and the serving forward
requires weights already in the compute dtype.  Training does what the
reference does: :func:`lm_loss` takes f32 master weights and
``forward_hidden(..., remat=True)`` casts each layer's weights inside the
layer body, which ``torch.utils.checkpoint`` re-runs in the backward pass.
A cast is deterministic, so both paths give the same numbers for the same
weights.

The hybrid family (zamba2) runs in groups: ``shared_attn_every`` Mamba2
layers, then one application of the single shared attention block
(``params["shared_attn"]``), whose weights every group reuses and whose
KV cache each application keeps apart (``cache["k"][g]``).

The moe family is the dense one with each layer's MLP replaced by
:func:`layers.moe_block` (every layer: the reference ignores
``moe_every``); the layers' load-balance losses are summed into the
forward's aux, which :func:`lm_loss` adds with ``aux_weight``.  A decode
step routes its B tokens with the capacity of B tokens, so it may drop
assignments that a prefill of the same tokens keeps, as in the reference.

The encdec family (whisper) runs an encoder of dense layers without the
causal mask over frame embeddings (:func:`encode`), then decoder layers
that add cross-attention to the encoder's output between their
self-attention and their MLP.  A serving caller encodes once and writes
``cache["enc_out"]``; each decode step recomputes the cross-attention's
keys and values from it, as the reference does.  The vlm family (llava)
is the dense one with an image prefix: patch embeddings projected by
``mm_proj`` are put before the text, and the loss covers the text alone.
A decode step never sees the image, as in the reference: its cache holds
text positions only.

Under a mesh (``distributed.sharding.set_mesh``) the parameters, the
batch and the caches are DTensors (``sharding.params_shardings``,
``data.pipeline.SyntheticTokens.sharded_batch(step, mesh)``,
:func:`init_cache`'s ``mesh``), the reference's constraints stand at its
points, and the loss head runs on each rank's vocabulary shard
(:func:`_sharded_chunk_loss`).  The functions compute what they compute
on one device, exactly: a mesh never changes the model's function.

The compute path's trace (:func:`repro_torch.core.trace.compute`) has a
span at each of the model's parts: ``model.embed``, ``model.layer`` (its
index ``i``), ``model.cast`` (a layer's weights cast under remat),
``model.norm``, and ``model.loss_head`` over each ``model.loss_chunk``;
each says whether it ran as remat's ``recompute``.  The decode path
(:func:`serve_step`) has none.
While spans are live, identity marks at each checkpointed unit's input
and output make its backward pass, recompute included, the span
``model.layer.bwd`` or ``model.loss_head.bwd``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import trace as _trace
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.runtime import is_dtensor, resolve_device

Params = Dict[str, Any]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} (takes "
                         f"{FAMILIES})")


def _groups(cfg: ModelConfig) -> int:
    """The hybrid family's groups: shared_attn_every SSM layers and one
    shared-attention application each."""
    if cfg.n_layers % cfg.shared_attn_every:
        raise ValueError("hybrid needs n_layers divisible by "
                         "shared_attn_every")
    return cfg.n_layers // cfg.shared_attn_every


# --------------------------------------------------------------------------
# Initialization
# --------------------------------------------------------------------------

def init_lm(cfg: ModelConfig, seed: int = 0, *, device="cuda",
            dtype: torch.dtype = torch.float32) -> Params:
    """Random weights of ``cfg`` on ``device``, drawn in f32 from a
    ``torch.Generator`` seeded with ``seed``.  The distributions are the
    reference's; the numbers are not (torch's generator is not JAX's).
    Each leaf is cast to ``dtype`` as soon as it is drawn, so a bf16 model
    never holds its f32 weights at once (the same values as
    ``cast_params`` of the f32 weights).  ``device="meta"`` draws nothing:
    the tree of shapes and dtypes a restore is given as ``like``."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = (L.SHAPES_ONLY if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    n = cfg.n_layers
    kw = dict(stack=n, dtype=dtype)
    p: Params = {
        "embed": L._init(gen, (cfg.vocab, cfg.d_model), scale=0.02,
                         dtype=dtype),
        "final_norm": L.init_rms_norm(cfg.d_model, device=dev, dtype=dtype),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L._init(gen, (cfg.d_model, cfg.vocab), dtype=dtype)
    if cfg.family in ("ssm", "hybrid"):
        p["layers"] = {
            "ln1": L.init_rms_norm(cfg.d_model, device=dev, **kw),
            "ssm": SSM.init_ssm(gen, cfg, **kw),
        }
        if cfg.family == "hybrid":
            _groups(cfg)
            p["shared_attn"] = {
                "ln": L.init_rms_norm(cfg.d_model, device=dev, dtype=dtype),
                "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.head_dim_,
                                         cfg.qk_norm, dtype=dtype),
            }
        return p
    if cfg.family == "encdec":
        p["enc_layers"] = _init_layers(cfg, gen, dev, cfg.encoder_layers,
                                       dtype)
        p["enc_norm"] = L.init_rms_norm(cfg.d_model, device=dev, dtype=dtype)
    p["layers"] = _init_layers(cfg, gen, dev, n, dtype,
                               cross=cfg.family == "encdec")
    if cfg.family == "vlm":
        p["mm_proj"] = L._init(gen, (cfg.d_model, cfg.d_model), dtype=dtype)
    return p


def _init_layers(cfg: ModelConfig, gen, dev, n: int, dtype,
                 cross: bool = False) -> Params:
    """``n`` stacked attention layers: norms, self-attention, (with
    ``cross``, a norm and the cross-attention of a decoder layer,) and the
    MLP or, in the moe family, the MoE block."""
    kw = dict(stack=n, dtype=dtype)

    def attention():
        return L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.head_dim_, cfg.qk_norm,
                                **kw)

    p = {"ln1": L.init_rms_norm(cfg.d_model, device=dev, **kw),
         "attn": attention()}
    if cross:
        p["ln_x"] = L.init_rms_norm(cfg.d_model, device=dev, **kw)
        p["cross"] = attention()
    p["ln2"] = L.init_rms_norm(cfg.d_model, device=dev, **kw)
    if cfg.family == "moe":
        p["moe"] = L.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                              cfg.mlp_type, cfg.shared_expert, **kw)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, **kw)
    return p


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Every floating-point leaf cast to ``dtype`` — once, at load time.
    Leaves already in ``dtype`` are kept (no copy)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, torch.Tensor) and params.is_floating_point():
        return params.to(dtype)
    return params


def _check_dtype(params: Params, dtype: torch.dtype) -> None:
    if params["embed"].dtype != dtype:
        raise ValueError(f"weights are {params['embed'].dtype}, the model "
                         f"computes in {dtype}: cast them once with "
                         f"cast_params(params, {dtype})")


def _unstack(tree, n: int) -> List[Any]:
    """Per-layer views of a stacked subtree (one ``unbind`` per leaf)."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _norm(x, w, eps):
    with _trace.compute("norm", "model"):
        return L.rms_norm(x, w, eps)


class _OpenBackwardSpan(torch.autograd.Function):
    """The identity at a checkpointed unit's output: its backward, the
    unit's first, opens the span ``model.<name>`` in ``cell``."""

    @staticmethod
    def forward(ctx, x, cell, name, args):
        ctx.cell, ctx.name, ctx.args = cell, name, args
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        c = _trace.live()
        if c is not None:
            span = c.compute(ctx.name, "model", backward=True)
            span.add(**ctx.args)
            ctx.cell.append(span.start())
        return g, None, None, None


class _CloseBackwardSpan(torch.autograd.Function):
    """The identity at a checkpointed unit's input: its backward, after
    the unit's, closes the span its output's mark opened."""

    @staticmethod
    def forward(ctx, x, cell):
        ctx.cell = cell
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.cell:
            ctx.cell.pop().stop()
        return g, None


def _same(x):
    return x


def _backward_span(x, name: str, **args):
    """``(x, mark)``: while spans are live and ``x`` carries a gradient,
    ``x`` through an identity whose backward closes the span ``model.<name>``
    and ``mark``, the identity for the unit's output whose backward opens
    it; otherwise ``x`` and the identity function (no autograd node)."""
    if _trace.live() is None or not (torch.is_grad_enabled()
                                     and x.requires_grad):
        return x, _same
    cell: List[Any] = []
    x = _CloseBackwardSpan.apply(x, cell)
    return x, lambda out: _OpenBackwardSpan.apply(out, cell, name, args)


# --------------------------------------------------------------------------
# Forward (prefill): hidden states
# --------------------------------------------------------------------------

def _windows_per_layer(cfg: ModelConfig, S_kv: int) -> Optional[List[int]]:
    """Per-layer effective window, or None."""
    if cfg.attn_window == 0:
        return None
    return [S_kv if cfg.layer_is_global(i) else cfg.attn_window
            for i in range(cfg.n_layers)]


def _attn_kwargs(cfg: ModelConfig):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim_, rope_base=cfg.rope_base,
                eps=cfg.norm_eps)


def _ffn(cfg: ModelConfig, lp: Params, h):
    """A layer's feed-forward on its normed input: (out, the MoE block's
    aux loss, or None in a dense layer)."""
    if cfg.family == "moe":
        return L.moe_block(lp["moe"], h, n_experts=cfg.n_experts,
                           top_k=cfg.experts_top_k, mlp_type=cfg.mlp_type,
                           capacity_factor=cfg.capacity_factor,
                           shared_expert=cfg.shared_expert)
    return L.mlp_block(lp["mlp"], h, cfg.mlp_type), None


@sh.under_mesh
def _layer(cfg: ModelConfig, lp: Params, x, window: Optional[int],
           kv_chunk: int, dtype: Optional[torch.dtype] = None,
           causal: bool = True, enc_out: Optional[torch.Tensor] = None,
           i: int = 0):
    """One layer's residual update of ``x``: (x, the layer's MoE aux loss,
    or None outside the moe family).  With ``dtype`` the layer's weights
    are cast to it first (the training path's per-layer cast).  An
    encoder layer attends with ``causal=False``; a decoder layer of the
    encdec family attends to ``enc_out`` after its self-attention.  ``i``
    is the layer's index in its span."""
    with _trace.compute("layer", "model") as span:
        if span:
            span.add(i=i)
        if dtype is not None:
            with _trace.compute("cast", "model"):
                lp = cast_params(lp, dtype)
        return _layer_body(cfg, lp, x, window, kv_chunk, causal, enc_out)


def _layer_body(cfg, lp, x, window, kv_chunk, causal, enc_out):
    lp = sh.gather_data_axes(lp)
    eps = cfg.norm_eps
    x = sh.constrain(x, "batch", None, None)
    if cfg.family in ("ssm", "hybrid"):
        return x + SSM.ssm_block(lp["ssm"], _norm(x, lp["ln1"], eps),
                                 cfg), None
    h = _norm(x, lp["ln1"], eps)
    x = x + L.attention_block(lp["attn"], h, causal=causal, window=window,
                              kv_chunk=kv_chunk, **_attn_kwargs(cfg))
    if enc_out is not None:
        x = x + _cross_attention(cfg, lp["cross"],
                                 _norm(x, lp["ln_x"], eps), enc_out)
    h, aux = _ffn(cfg, lp, _norm(x, lp["ln2"], eps))
    return x + h, aux


def _cross_attention(cfg: ModelConfig, p: Params, x, enc_out):
    """Decoder-to-encoder attention: queries from ``x``, keys and values
    from ``enc_out``, no causal mask, no RoPE and no qk-norm (the
    reference's ``_cross_attention``).  The keys and values are computed
    from ``enc_out`` in every call, a decode step's too."""
    _, kv_pad, _ = L.head_layout(cfg.n_heads, cfg.n_kv_heads)
    q = L._heads(x, L.pad_heads(p["wq"], 1, cfg.n_heads, cfg.n_kv_heads))
    k = L._heads(enc_out, L._pad_axis(p["wk"], 1, kv_pad))
    v = L._heads(enc_out, L._pad_axis(p["wv"], 1, kv_pad))
    q = sh.constrain(q, "batch", None, "model", None)
    out = ops.flash_attention(q, k, v, causal=False)
    return L._output_proj(p, out, cfg.n_heads, x.shape[-1])


def _hybrid_group(cfg: ModelConfig, group: List[Params], sa: Params, x,
                  kv_chunk: int, dtype: Optional[torch.dtype] = None,
                  first: int = 0):
    """One hybrid group's residual updates of ``x``: its SSM layers (the
    model's ``first``, ``first + 1``, …), then the shared attention block
    ``sa`` (already in the compute dtype)."""
    for i, lp in enumerate(group, first):
        x, _ = _layer(cfg, lp, x, None, kv_chunk, dtype, i=i)
    h = _norm(x, sa["ln"], cfg.norm_eps)
    return x + L.attention_block(sa["attn"], h, kv_chunk=kv_chunk,
                                 **_attn_kwargs(cfg))


def encode(cfg: ModelConfig, params: Params, enc_embeds,
           kv_chunk: int = 512, remat: bool = False) -> torch.Tensor:
    """The encdec family's encoder: frame embeddings (B, S_src, d) through
    the encoder layers (self-attention without the causal mask, then the
    MLP) and ``enc_norm`` → (B, S_src, d) in the compute dtype.  A serving
    caller writes its output into ``cache["enc_out"]``.  ``remat`` as in
    :func:`forward_hidden`, each encoder layer a checkpointed body."""
    if enc_embeds is None:
        raise ValueError(f"{cfg.name}: the encdec family needs encoder "
                         f"embeddings (enc_embeds)")
    dtype = compute_dtype(cfg)
    if not remat:
        _check_dtype(params, dtype)
    e = sh.constrain(enc_embeds.to(dtype), "batch", None, None)
    for i, lp in enumerate(_unstack(params["enc_layers"],
                                    cfg.encoder_layers)):
        if remat:
            e, mark = _backward_span(e, "layer.bwd", i=i)
            e, _ = checkpoint(_layer, cfg, lp, e, None, kv_chunk, dtype,
                              False, use_reentrant=False, i=i)
            e = mark(e)
        else:
            e, _ = _layer(cfg, lp, e, None, kv_chunk, causal=False, i=i)
    return _norm(e, params["enc_norm"].to(dtype), cfg.norm_eps)


@sh.under_mesh
def forward_hidden(cfg: ModelConfig, params: Params, tokens,
                   patch_embeds=None, enc_embeds=None, kv_chunk: int = 512,
                   remat: bool = False) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids (B, S) → final hidden states (B, S, d), or (B, P + S, d)
    in the vlm family. Returns (hidden, moe_aux): the sum of the moe
    layers' load-balance losses, f32, 0 in the other families.

    The vlm family needs ``patch_embeds`` (B, P, d): projected by
    ``mm_proj``, they are put before the text, and RoPE positions run over
    the whole sequence.  The encdec family needs ``enc_embeds`` (B, S_src,
    d): :func:`encode` runs first, and every decoder layer attends to its
    output.

    ``remat=False`` (serving) takes weights already cast to the compute
    dtype.  ``remat=True`` (training) takes master weights of any float
    dtype: the embedding rows are cast after the gather, each layer's
    weights inside its layer body, and each body runs under
    ``torch.utils.checkpoint``, so the backward pass recomputes a layer's
    internals instead of keeping them (the reference's remat'd scan).  A
    hybrid model's body is a whole group, as the reference remats its
    group scan; its shared attention weights are cast once, outside.  An
    encdec model's bodies are its encoder layers and its decoder layers.
    """
    _check_family(cfg)
    dtype = compute_dtype(cfg)
    if not remat:
        _check_dtype(params, dtype)
    with _trace.compute("embed", "model"):
        x = sh.constrain(_embed(params["embed"], tokens).to(dtype), "batch",
                         None, None)
    if cfg.family == "vlm":
        if patch_embeds is None:
            raise ValueError(f"{cfg.name}: the vlm family needs patch "
                             f"embeddings (patch_embeds)")
        prefix = patch_embeds.to(dtype) @ params["mm_proj"].to(dtype)
        x = torch.cat([prefix, x], dim=1)
    enc_out = (encode(cfg, params, enc_embeds, kv_chunk, remat)
               if cfg.family == "encdec" else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _unstack(params["layers"], cfg.n_layers)
    if cfg.family == "hybrid":
        E = cfg.shared_attn_every
        sa = sh.gather_data_axes(cast_params(params["shared_attn"], dtype))
        for g in range(_groups(cfg)):
            group = layers[g * E:(g + 1) * E]
            if remat:
                x, mark = _backward_span(x, "layer.bwd", group=g)
                x = mark(checkpoint(_hybrid_group, cfg, group, sa, x,
                                    kv_chunk, dtype, g * E,
                                    use_reentrant=False))
            else:
                x = _hybrid_group(cfg, group, sa, x, kv_chunk, first=g * E)
    else:
        windows = _windows_per_layer(cfg, x.shape[1])
        for i, lp in enumerate(layers):
            window = None if windows is None else windows[i]
            if remat:
                x, mark = _backward_span(x, "layer.bwd", i=i)
                x, a = checkpoint(_layer, cfg, lp, x, window, kv_chunk,
                                  dtype, True, enc_out, use_reentrant=False,
                                  i=i)
                x = mark(x)
            else:
                x, a = _layer(cfg, lp, x, window, kv_chunk, enc_out=enc_out,
                              i=i)
            if a is not None:
                aux = aux + a
    x = _norm(x, params["final_norm"].to(dtype), cfg.norm_eps)
    return x, aux


def unembed(cfg: ModelConfig, params: Params, hidden):
    """Logits of ``hidden``; under a mesh the unembedding is gathered over
    the data axes, its vocabulary on the model axis where it divides."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    mesh = sh.get_policy().mesh
    if mesh is not None:
        w = w.redistribute(mesh, sh.placements(mesh, sh.constrain_spec(
            mesh, tuple(w.shape), None, "model")))
    return hidden @ w.to(hidden.dtype)


def forward(cfg: ModelConfig, params: Params, tokens, **kw):
    """Full logits (small-model / test path)."""
    hidden, _ = forward_hidden(cfg, params, tokens, **kw)
    return unembed(cfg, params, hidden).float()


# --------------------------------------------------------------------------
# Loss with a sequence-chunked, remat'd softmax head
# --------------------------------------------------------------------------

def _embed(table, tokens):
    """The rows of ``table`` at ``tokens``.  Under a mesh each rank gathers
    from its own block of the table (a vocabulary or d_model shard): over
    a mesh dim that shards the table the tokens are made whole (they are
    small), and the rows come out as partial sums (vocabulary shards) or
    d_model shards; over the other dims they keep their batch shard.
    Nothing gathers the table."""
    if not isinstance(tokens, torch.Tensor) or not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = sh.distribute(tokens, mesh, sh.P())
    tab_pl = list(table.placements)
    tok_pl = [Replicate() if wp.is_shard() or not tp.is_shard(0) else tp
              for tp, wp in zip(tokens.placements, tab_pl)]
    out_pl = [Partial() if wp.is_shard(0) else Shard(2) if wp.is_shard(1)
              else Shard(0) if tp.is_shard(0) else Replicate()
              for tp, wp in zip(tok_pl, tab_pl)]
    vocab_dims = [i for i, wp in enumerate(tab_pl) if wp.is_shard(0)]

    def local(w, t):
        if not vocab_dims:
            return w[t]
        lo = sum(mesh.get_coordinate()[i] * w.shape[0]
                 for i in vocab_dims)    # one vocab dim at most
        idx = t.long() - lo
        inside = (idx >= 0) & (idx < w.shape[0])
        rows = w[idx.clamp(0, w.shape[0] - 1)]
        return rows * inside[..., None].to(rows.dtype)

    # the table's gradient is a part of the sum over a dim whose ranks
    # gather from it with different tokens
    tab_grad = [Partial() if tp.is_shard() else wp
                for tp, wp in zip(tok_pl, tab_pl)]
    return local_map(local, out_placements=out_pl,
                     in_placements=(tab_pl, tok_pl),
                     in_grad_placements=(tab_grad, tok_pl), device_mesh=mesh)(
        table, tokens.redistribute(mesh, tok_pl))


def _loss_chunk(loss_fn, i: int, h, w, y):
    """``loss_fn(h, w, y)`` of loss chunk ``i``, in its span (the body
    that ``torch.utils.checkpoint`` runs again in the backward pass)."""
    with _trace.compute("loss_chunk", "model") as span:
        if span:
            span.add(chunk=i)
        return loss_fn(h, w, y)


def _chunk_loss(h, w, y):
    """Sum over a chunk of (logsumexp - gold logit), the logits in f32."""
    logits = (h @ w).float()
    gold = torch.gather(logits, -1, y[..., None])[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


class _VocabXent(torch.autograd.Function):
    """Per-token (logsumexp - gold logit) of f32 logits whose last dim is
    this rank's vocabulary slice [v0, v0 + V_local), the rows' max and
    sums all-reduced over ``group`` (None: the slice is the whole
    vocabulary).  The backward is local: softmax minus the gold one-hot,
    from the saved probabilities."""

    @staticmethod
    def forward(ctx, logits, y, v0: int, group):
        mx = logits.amax(-1, keepdim=True)
        if group is not None:
            coll.all_reduce(mx, "max", group)
        e = torch.exp(logits - mx)
        V = logits.shape[-1]
        idx = y.long() - v0
        inside = (idx >= 0) & (idx < V)
        idx = idx.clamp(0, V - 1)
        gold = torch.gather(logits, -1, idx[..., None])[..., 0] * inside
        sums = torch.stack([e.sum(-1), gold])
        if group is not None:
            coll.all_reduce(sums, "sum", group)
        ctx.save_for_backward(e / sums[0][..., None], idx, inside)
        return torch.log(sums[0]) + mx[..., 0] - sums[1]

    @staticmethod
    def backward(ctx, g):
        p, idx, inside = ctx.saved_tensors
        grad = p.scatter_add(-1, idx[..., None],
                             -inside[..., None].to(p.dtype))
        return grad * g[..., None], None, None, None


class _SumOver(torch.autograd.Function):
    """The sum over ``group`` of a value each rank holds a part of, the
    result every rank's; its gradient reaches each part unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        coll.all_reduce(x, "sum", group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sharded_chunk_loss(h, w, y):
    """:func:`_chunk_loss` of DTensors: h (B, c, d) and y (B, c) batch
    sharded on the data axes, the unembedding w (d, V) sharded on V over
    the model axis where it divides (the reference's ``constrain(logits,
    "batch", None, "model")``).  Each rank makes the logits of its batch
    and vocabulary shard alone; the sum over the batch shards is every
    rank's."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = sh.get_policy().mesh
    h = sh.constrain(h, "batch", None, None)
    y = sh.constrain(y, "batch", None)
    spec = sh.constrain_spec(mesh, (w.shape[0], w.shape[1]), None, "model")
    w = w.redistribute(mesh, sh.placements(mesh, spec))
    names = list(mesh.mesh_dim_names)
    vocab_axis = spec[1]
    batch_axes = [names[i] for i, p in enumerate(h.placements)
                  if p.is_shard(0)]
    groups = {a: mesh.get_group(a) for a in names}
    out_pl = [Replicate()] * mesh.ndim

    def local(hl, wl, yl):
        v0 = (mesh.get_local_rank(vocab_axis) * wl.shape[1]
              if vocab_axis else 0)
        tok = _VocabXent.apply((hl @ wl).float(), yl, v0,
                               groups[vocab_axis] if vocab_axis else None)
        total = tok.sum()
        for a in batch_axes:
            total = _SumOver.apply(total, groups[a])
        return total

    # each rank's gradient of h is its vocabulary slice's part, of w its
    # batch shard's part
    h_grad = [Partial() if vocab_axis == n else p
              for n, p in zip(names, h.placements)]
    w_grad = [Partial() if n in batch_axes else p
              for n, p in zip(names, w.placements)]
    return local_map(local, out_placements=out_pl,
                     in_placements=(list(h.placements), list(w.placements),
                                    list(y.placements)),
                     in_grad_placements=(h_grad, w_grad,
                                         list(y.placements)),
                     device_mesh=mesh)(h, w, y)


def lm_loss(cfg: ModelConfig, params: Params, tokens, labels,
            loss_chunk: int = 256, aux_weight: float = 0.01,
            remat: bool = True, patch_embeds=None, enc_embeds=None,
            kv_chunk: int = 512):
    """Mean next-token cross entropy of ``labels`` (B, S) (integer ids)
    given ``tokens`` (B, S), from master weights (see
    :func:`forward_hidden`'s ``remat``), plus ``aux_weight`` times the
    MoE layers' summed load-balance loss (0 outside the moe family).
    ``patch_embeds`` and ``enc_embeds`` go to :func:`forward_hidden`; a
    vlm model's image prefix carries no loss.

    The head runs over ``loss_chunk``-token slices of the sequence, each
    under ``torch.utils.checkpoint``, so the (B, S, vocab) f32 logits never
    exist whole: a chunk's are recomputed in the backward pass.  The
    unembedding is cast to the compute dtype once per call.
    """
    with sh.mesh_region():
        loss = _lm_loss(cfg, params, tokens, labels, loss_chunk, aux_weight,
                        remat, patch_embeds, enc_embeds, kv_chunk)
    sh.backward_in_mesh_region(loss)
    return loss


def _lm_loss(cfg, params, tokens, labels, loss_chunk, aux_weight, remat,
             patch_embeds, enc_embeds, kv_chunk):
    hidden, aux = forward_hidden(cfg, params, tokens, patch_embeds,
                                 enc_embeds, kv_chunk, remat)
    if cfg.family == "vlm":
        hidden = hidden[:, -tokens.shape[1]:]
    B, S, _ = hidden.shape
    n = max(1, S // loss_chunk)
    chunk = S // n
    if n * chunk != S:
        raise ValueError(f"seq {S} not divisible into {n} loss chunks")
    with _trace.compute("loss_head", "model"):
        hidden, mark = _backward_span(hidden, "loss_head.bwd")
        w = (params["embed"].T if cfg.tie_embeddings
             else params["lm_head"]).to(hidden.dtype)
        labels = labels.long()
        mesh = sh.get_policy().mesh
        if mesh is not None:
            if not is_dtensor(labels):
                labels = sh.distribute(labels, mesh, sh.P())
            # the head's layout once a call, not once a chunk and again in
            # each chunk's recompute: its vocabulary on the model axis
            w = w.redistribute(mesh, sh.placements(mesh, sh.constrain_spec(
                mesh, tuple(w.shape), None, "model")))
        loss_fn = _chunk_loss if mesh is None else _sharded_chunk_loss
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(n):
            part = slice(i * chunk, (i + 1) * chunk)
            total = total + checkpoint(_loss_chunk, loss_fn, i,
                                       hidden[:, part], w, labels[:, part],
                                       use_reentrant=False)
        total = mark(total)
    return total / (B * S) + aux_weight * aux


# --------------------------------------------------------------------------
# Decode (serve) path with layer-stacked caches
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda", mesh=None) -> Params:
    """Zero decode cache on ``device``: the position, and per layer a KV
    cache of ``max_len`` (dense) or the SSM state, h in f32 ((L, B,
    d_inner, N) for Mamba1, (L, B, H, N, P) for Mamba2) and the conv window
    (L, B, K-1, d_inner) in the compute dtype (ssm; its size does not
    depend on ``max_len``).  A hybrid model has both: the SSM state of its
    layers and a KV cache of ``max_len`` for each of its G shared-attention
    applications, (G, B, max_len, Hkv, D).  An encdec model also holds
    ``enc_out`` (B, max_source_len, d) in the compute dtype, zeros until
    the caller writes :func:`encode`'s output there.

    With ``mesh`` the caches are DTensors on it with the placements of
    ``sharding.input_shardings(mesh, "decode", ...)``: the batch on the
    data axes where they divide it, else the sequence (sequence-parallel
    decode), kv heads on the model axis; each rank allocates its block
    alone.  ``pos`` stays a plain tensor every rank holds."""
    if mesh is not None:
        return _init_cache_on(cfg, batch, max_len, device, mesh)
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = compute_dtype(cfg)
    cache: Params = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.family in ("ssm", "hybrid"):
        cache["ssm"] = SSM.init_ssm_state(cfg, batch, dtype,
                                          stack=cfg.n_layers, device=dev)
        if cfg.family == "ssm":
            return cache
    n = _groups(cfg) if cfg.family == "hybrid" else cfg.n_layers
    shape = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
    cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.family == "encdec":
        cache["enc_out"] = torch.zeros((batch, cfg.max_source_len,
                                        cfg.d_model), dtype=dtype, device=dev)
    return cache


def _init_cache_on(cfg: ModelConfig, batch: int, max_len: int, device,
                   mesh) -> Params:
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.configs.base import ShapeConfig
    abstract = init_cache(cfg, batch, max_len, device="meta")
    specs = sh.input_shardings(mesh, "decode", cfg,
                               ShapeConfig("serve", "decode", max_len, batch))
    names = {"k": "cache_k", "v": "cache_v", "enc_out": "enc_out"}
    dev = resolve_device(device)

    def place(t, spec):
        pl = sh.placements(mesh, spec)
        shape, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        local = torch.zeros(shape, dtype=t.dtype, device=dev)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=torch.empty(
                                      t.shape, device="meta").stride())

    out: Params = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    for key, t in abstract.items():
        if key == "ssm":
            out["ssm"] = {n: place(a, specs["ssm_" + n])
                          for n, a in t.items()}
        elif key != "pos":
            out[key] = place(t, specs[names[key]])
    return out


@sh.under_mesh
def serve_step(cfg: ModelConfig, params: Params, cache: Params, tokens):
    """One decode step: tokens (B, 1) → (logits (B, vocab) f32, cache).

    The cache is updated IN PLACE (the reference returns a new one): each
    dense layer, and each hybrid group's shared-attention application,
    writes its new key/value at ``cache["pos"]`` with a device-side index;
    each ssm layer copies its new h and conv window over its slice of the
    stacked ``cache["ssm"]``.  ``cache["pos"]`` is replaced by ``pos + 1``
    on the device.  Nothing in the step reads a device value on the host.
    An encdec decoder layer attends to ``cache["enc_out"]`` after its
    self-attention; a vlm step is a dense one (it never sees the image).
    """
    _check_family(cfg)
    dtype = compute_dtype(cfg)
    _check_dtype(params, dtype)
    eps = cfg.norm_eps
    pos = cache["pos"]
    x = sh.constrain(_embed(params["embed"], tokens).to(dtype), "batch",
                     None, None)
    if cfg.family == "ssm":
        x = _ssm_decode_layers(cfg, _unstack(params["layers"], cfg.n_layers),
                               cache["ssm"], x, 0)
    elif cfg.family == "hybrid":
        x = _hybrid_decode_groups(cfg, params, cache, x)
    else:
        x = _dense_decode_layers(cfg, params, cache, x)
    x = L.rms_norm(x, params["final_norm"], eps)
    logits = unembed(cfg, params, x)[:, 0, :].float()
    cache["pos"] = pos + 1
    return logits, cache


def _ssm_decode_layers(cfg: ModelConfig, layers: List[Params],
                       state: Params, x, first: int):
    """One token through ``layers``, the model's layers ``first``,
    ``first + 1``, …; each reads its slice of the stacked ``state`` and
    overwrites it in place."""
    h_all, conv_all = state["h"], state["conv"]
    for i, lp in enumerate(layers, first):
        lp = sh.gather_data_axes(lp)
        h, st = SSM.ssm_decode(
            lp["ssm"], L.rms_norm(x, lp["ln1"], cfg.norm_eps),
            {"h": h_all[i], "conv": conv_all[i]}, cfg)
        h_all[i].copy_(st["h"])
        conv_all[i].copy_(st["conv"])
        # the output projection's partial sums, summed once a layer
        x = sh.constrain(x + h, "batch", None, None)
    return x


def _hybrid_decode_groups(cfg: ModelConfig, params: Params, cache: Params,
                          x):
    """Each group's SSM layers, then application g of the shared attention
    against its own KV cache ``cache["k"][g]``, ``cache["v"][g]``."""
    E = cfg.shared_attn_every
    pos = cache["pos"]
    pos_index = pos.reshape(1).long()
    layers = _unstack(params["layers"], cfg.n_layers)
    sa = sh.gather_data_axes(params["shared_attn"])
    for g in range(_groups(cfg)):
        x = _ssm_decode_layers(cfg, layers[g * E:(g + 1) * E], cache["ssm"],
                               x, g * E)
        h = L.rms_norm(x, sa["ln"], cfg.norm_eps)
        h, _, _ = L.attention_decode(
            sa["attn"], h, cache["k"][g], cache["v"][g], pos,
            pos_index=pos_index, **_attn_kwargs(cfg))
        x = x + h
    return x


def _dense_decode_layers(cfg: ModelConfig, params: Params, cache: Params,
                         x):
    eps = cfg.norm_eps
    pos = cache["pos"]
    pos_index = pos.reshape(1).long()
    windows = _windows_per_layer(cfg, cache["k"].shape[2])
    enc_out = cache.get("enc_out")
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        lp = sh.gather_data_axes(lp)
        h = L.rms_norm(x, lp["ln1"], eps)
        h, _, _ = L.attention_decode(
            lp["attn"], h, cache["k"][i], cache["v"][i], pos,
            window=None if windows is None else windows[i],
            pos_index=pos_index, **_attn_kwargs(cfg))
        x = x + h
        if enc_out is not None:
            x = x + _cross_attention(cfg, lp["cross"],
                                     L.rms_norm(x, lp["ln_x"], eps), enc_out)
        h, _ = _ffn(cfg, lp, L.rms_norm(x, lp["ln2"], eps))   # aux dropped
        x = x + h
    return x


def param_bytes(params: Params) -> int:
    """Total bytes of the tensors in ``params``."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


__all__ = ["FAMILIES", "compute_dtype", "init_lm", "cast_params",
           "encode", "forward_hidden", "unembed", "forward", "lm_loss",
           "init_cache", "serve_step", "param_bytes"]
