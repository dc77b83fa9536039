"""Divisibility-aware parameter placement over a ``DeviceMesh``: the
placement half of the reference's ``repro/distributed/sharding.py``.

Parameters carry *logical* roles inferred from their tree path and
shape; :func:`best_spec` assigns mesh axes with divisibility checks and
a fallback (granite's 49 155-row vocab cannot take a 16-way model axis,
so its embedding shards on d_model instead).  The rules and the specs
they give are the reference's, entry by entry: a :class:`PartitionSpec`
here is a tuple with one entry a tensor dim, each ``None``, a mesh axis
name, or a tuple of names.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names`` (``("data", "model")``, or ``("pod", "data",
"model")`` across pods).  :func:`placements` turns a spec into DTensor
placements, one a mesh dim, and :func:`params_shardings` gives a whole
parameter tree's restore targets: DTensors whose local tensors live on
the ``meta`` device, so ``checkpoint.restore(path, like=targets)`` reads
each rank's shard of each leaf and nothing else.

The ambient policy the model path reads: :func:`set_mesh` declares the
mesh (and, for long-context decode, the sequence-parallel axis),
:func:`constrain` redistributes an activation to the placements its
logical dim roles give, and :func:`padded_heads` / :func:`gqa_heads`
size the phantom heads tensor parallelism pads in.  No mesh set: every
one is the identity, so single-device runs never see a DTensor.
:func:`input_shardings` gives the step inputs' and caches' specs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple


class PartitionSpec(tuple):
    """The reference's ``jax.sharding.PartitionSpec`` as a plain tuple:
    ``PartitionSpec("data", None)`` shards dim 0 on the data axis."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec

MODEL_AXIS = "model"


# --------------------------------------------------------------------------
# Ambient mesh policy — lets model code place activation constraints without
# threading mesh objects through every function.  No mesh set → no-ops, so
# tests and single-device runs are unaffected.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Policy:
    mesh: Optional[Any] = None
    #: decode attention merges partial softmax over this axis when the KV
    #: cache is sequence-sharded (long-context SP decode).
    sp_decode_axis: Optional[str] = None


#: The process's policy.  The reference keeps one a thread; here the
#: backward pass of a CUDA tensor runs on autograd's device thread, whose
#: recomputed (remat'd) layers read the policy the forward ran under.
_POLICY = Policy()


def set_mesh(mesh, sp_decode_axis: Optional[str] = None) -> None:
    """Declare the ambient mesh (a ``DeviceMesh`` with named dims, or
    None) for the process's model code.  While a CUDA mesh over gloo is
    set, DTensor's collectives take
    ``collectives.route_dtensor_collectives``'s route."""
    global _POLICY
    from repro_torch.distributed import collectives
    routed = False
    if mesh is not None and mesh.device_type == "cuda":
        import torch.distributed as dist
        routed = dist.get_backend(mesh.get_group(0)) == "gloo"
    collectives.route_dtensor_collectives(routed)
    _POLICY = Policy(mesh=mesh, sp_decode_axis=sp_decode_axis)


def get_policy() -> Policy:
    return _POLICY


def model_axis_size() -> int:
    mesh = get_policy().mesh
    return axis_size(mesh, MODEL_AXIS) if mesh is not None else 1


def role_axes(mesh, role):
    """The mesh axis (or axes) a logical dim role shards on: None, "batch"
    and "seq_data" the data axes, "model" and "seq_model" the model
    axis."""
    if role is None:
        return None
    if role in ("batch", "seq_data"):
        axes = data_axes(mesh)
        return axes if len(axes) > 1 else axes[0]
    if role in ("model", "seq_model"):
        return MODEL_AXIS
    raise ValueError(role)


def constrain_spec(mesh, shape: Sequence[int], *logical) -> PartitionSpec:
    """The spec :func:`constrain` gives a tensor of ``shape`` on ``mesh``:
    each role's axes, dropped where they do not divide the dim
    (correctness first).  Dims past the roles are unsharded."""
    spec = []
    for dim, role in zip(shape, logical):
        ax = role_axes(mesh, role)
        spec.append(ax if ax is not None and dim % axis_size(mesh, ax) == 0
                    else None)
    spec += [None] * (len(shape) - len(spec))
    return P(*spec)


def distribute(x, mesh, spec: Sequence[Any]):
    """``x``, a whole tensor that every rank of ``mesh`` holds, as a DTensor
    with ``spec``'s placements: each rank keeps its block, no collective."""
    from torch.distributed.tensor import DTensor, Replicate
    whole = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return whole.redistribute(mesh, placements(mesh, spec))


def constrain(x, *logical):
    """Redistribute ``x`` to the placements of its dim roles (the
    reference's ``with_sharding_constraint``; see :func:`constrain_spec`).
    Roles per dim: None (unsharded: gathered if sharded), "batch" (data
    axes), "model", or "seq_model"/"seq_data".  No mesh set: ``x``
    untouched.  A plain tensor under a mesh is taken as the whole value
    every rank holds."""
    mesh = get_policy().mesh
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    want = placements(mesh, constrain_spec(mesh, x.shape, *logical))
    if not isinstance(x, DTensor):
        return distribute(x, mesh, constrain_spec(mesh, x.shape, *logical))
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def mesh_region():
    """The context a region of model code under a mesh runs in: plain
    tensors it makes (positions, masks, scalars) meet the DTensors as
    values every rank holds whole (DTensor's implicit replication).
    Without a mesh, a context that does nothing."""
    if get_policy().mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor import DTensor
    if DTensor._op_dispatcher._allow_implicit_replication:
        # already inside one: the context's exit would switch it off
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def backward_in_mesh_region(loss) -> None:
    """Make the backward pass from ``loss`` run in :func:`mesh_region`:
    DTensor's implicit replication is a flag of each thread, and autograd
    runs a CUDA tensor's backward on its device thread, where the ops that
    met plain tensors in the forward meet them again.  A hook on ``loss``,
    the first thing the backward runs, turns the flag on in its thread,
    and a callback at the end of that backward pass gives the flag its
    value back there."""
    def hook(grad):
        import threading
        import torch
        from torch.distributed.tensor import DTensor
        dispatcher = DTensor._op_dispatcher
        was = dispatcher._allow_implicit_replication
        thread = threading.get_ident()
        dispatcher._allow_implicit_replication = True

        def restore():
            if threading.get_ident() == thread:
                dispatcher._allow_implicit_replication = was

        torch.autograd.Variable._execution_engine.queue_callback(restore)
        return grad
    if get_policy().mesh is not None and loss.requires_grad:
        loss.register_hook(hook)


def under_mesh(fn):
    """Run ``fn`` inside :func:`mesh_region`."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with mesh_region():
            return fn(*args, **kwargs)
    return wrapped


def gather_data_axes(tree):
    """FSDP's unshard: every DTensor leaf of ``tree`` (nested dicts) made
    whole over the data axes, its model-axis shard kept; other leaves as
    they are.  The model path gathers a layer's weights so before the
    layer runs: its products are then tensor-parallel alone, and no
    matmul sums partial products over the data axes in the compute
    dtype.  Without gradients (serving) the leaves' blocks travel in one
    all-gather a dtype (``collectives.gather_blocks``); with them each
    leaf is redistributed, and autograd reduce-scatters its gradient.  No
    mesh set: ``tree`` itself."""
    mesh = get_policy().mesh
    if mesh is None:
        return tree
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    daxes = set(data_axes(mesh))
    names = mesh.mesh_dim_names
    want = {}

    def plan(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                plan(v, path + (k,))
        elif isinstance(t, DTensor):
            pl = [Replicate() if n in daxes else p
                  for n, p in zip(names, t.placements)]
            if pl != list(t.placements):
                want[path] = pl

    plan(tree, ())
    if not want:
        return tree
    leaves = {}

    def get(t, path):
        for k in path:
            t = t[k]
        return t

    coalesce = len(daxes) == 1 and not (torch.is_grad_enabled() and any(
        get(tree, p).requires_grad for p in want))
    if coalesce:
        from repro_torch.distributed import collectives
        axis = next(iter(daxes))
        ts = [get(tree, p) for p in want]
        dims = [t.placements[names.index(axis)].dim for t in ts]
        locals_ = collectives.gather_blocks(
            [t.to_local() for t in ts], dims, mesh.get_group(axis))
        for p, t, local in zip(want, ts, locals_):
            leaves[p] = DTensor.from_local(local, mesh, want[p],
                                           run_check=False, shape=t.shape,
                                           stride=t.stride())
    else:
        for p, pl in want.items():
            leaves[p] = get(tree, p).redistribute(mesh, pl)

    def rebuild(t, path):
        if isinstance(t, dict):
            return {k: rebuild(v, path + (k,)) for k, v in t.items()}
        return leaves.get(path, t)

    return rebuild(tree, ())


def padded_heads(n_heads: int) -> int:
    """Round the head count up to a model-axis multiple (the reference's
    forward-time pad): the MHA layout, where kv heads are padded with
    q heads."""
    m = model_axis_size()
    if m <= 1 or n_heads % m == 0:
        return n_heads
    return ((n_heads + m - 1) // m) * m


def gqa_heads(n_heads: int, n_kv: int) -> int:
    """q heads per kv group once phantom heads are padded in, exactly: the
    smallest count at least ``n_heads // n_kv`` whose total ``n_kv *
    count`` the model axis divides.  Phantom heads go last in each group,
    so q head h of group g keeps reading kv head g (the reference pads
    after the last group, which moves GQA heads to other kv heads).  The
    totals are ``padded_heads``' at gemma3's 8/4, granite's 24/8 and
    llama4's 40/8 on a 16-way model axis (16, 32, 48)."""
    group = n_heads // n_kv
    m = model_axis_size()
    if m <= 1 or n_heads % m == 0:
        return group
    step = m // math.gcd(n_kv, m)
    return -(-group // step) * step


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = _axis_sizes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    return math.prod(sizes[a] for a in axes)


def data_axes(mesh) -> Tuple[str, ...]:
    """The batch/FSDP axes: ('pod', 'data') when multi-pod, else ('data',)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _divisible(dim: int, n: int) -> bool:
    return n > 0 and dim % n == 0


def best_spec(mesh, shape: Sequence[int],
              prefer_model: Sequence[int],
              prefer_data: Sequence[int] = (),
              skip: Sequence[int] = ()) -> PartitionSpec:
    """Assign mesh axes to tensor dims.

    ``prefer_model``: dim indices to try for the model (TP) axis, in order.
    ``prefer_data``: dim indices to try for the FSDP axes (defaults to all
    dims, largest first, excluding the model dim).
    Dims that do not divide are skipped — correctness first.
    """
    ndim = len(shape)
    assign: Dict[int, Any] = {}
    msize = axis_size(mesh, MODEL_AXIS)
    model_dim = None
    for d in prefer_model:
        if d < ndim and d not in skip and _divisible(shape[d], msize):
            assign[d] = MODEL_AXIS
            model_dim = d
            break
    daxes = data_axes(mesh)
    dsize = axis_size(mesh, daxes)
    cand = list(prefer_data) or sorted(
        range(ndim), key=lambda i: -shape[i])
    for d in cand:
        if d < ndim and d != model_dim and d not in skip \
                and _divisible(shape[d], dsize):
            assign[d] = daxes if len(daxes) > 1 else daxes[0]
            break
    return P(*[assign.get(i) for i in range(ndim)])


# --------------------------------------------------------------------------
# Parameter rules by tree-path pattern (order matters: first match wins)
# --------------------------------------------------------------------------
# Stacked layer params carry a leading n_layers dim (never sharded); the
# rule's dim indices are *relative to the unstacked tensor*.

_RULES = [
    # attention projections (d_model, H, hd) — TP on heads, hd fallback
    (re.compile(r"(attn|cross)/w[qkv]$"), dict(model=[1, 2], data=[0])),
    (re.compile(r"(attn|cross)/wo$"), dict(model=[0, 1], data=[2])),
    # MoE: experts first (EP), else expert-internal d_ff TP
    (re.compile(r"moe/router$"), dict(model=[1], data=[0])),
    (re.compile(r"moe/w_(gate|up)$"), dict(model=[0, 2], data=[1])),
    (re.compile(r"moe/w_down$"), dict(model=[0, 1], data=[2])),
    (re.compile(r"shared/w_(gate|up)$"), dict(model=[1], data=[0])),
    (re.compile(r"shared/w_down$"), dict(model=[0], data=[1])),
    # dense MLPs — TP on d_ff
    (re.compile(r"mlp/w_(gate|up)$"), dict(model=[1], data=[0])),
    (re.compile(r"mlp/w_down$"), dict(model=[0], data=[1])),
    # SSM: TP on d_inner (projections) / heads
    (re.compile(r"ssm/in_[xz]$"), dict(model=[1], data=[0])),
    (re.compile(r"ssm/in_(B|C|dt)$"), dict(model=[], data=[0])),
    (re.compile(r"ssm/out_proj$"), dict(model=[0], data=[1])),
    (re.compile(r"ssm/x_proj$"), dict(model=[0], data=[1])),
    (re.compile(r"ssm/dt_proj$"), dict(model=[1], data=[0])),
    (re.compile(r"ssm/(conv_w|conv_b|A_log|D|dt_bias|norm)$"),
     dict(model=[0], data=[])),
    # embeddings / unembeddings — vocab first, d_model fallback
    (re.compile(r"^embed$"), dict(model=[0, 1], data=[1, 0])),
    (re.compile(r"^lm_head$"), dict(model=[1, 0], data=[0, 1])),
    (re.compile(r"^mm_proj$"), dict(model=[1], data=[0])),
    # norms and 1-D params: replicated
    (re.compile(r"(ln\w*|norm|final_norm|enc_norm)$"), dict(model=[], data=[])),
]


def param_spec(mesh, name: str, shape: Sequence[int],
               stacked: bool) -> PartitionSpec:
    """PartitionSpec for a (possibly layer-stacked) parameter."""
    off = 1 if stacked else 0
    inner = shape[off:]
    for pat, rule in _RULES:
        if pat.search(name):
            spec = best_spec(mesh, inner, rule["model"], rule["data"])
            return P(*([None] * off), *spec)
    # default: FSDP on the largest divisible dim
    spec = best_spec(mesh, inner, prefer_model=[])
    return P(*([None] * off), *spec)


def leaf_spec(mesh, name: str, leaf) -> PartitionSpec:
    """:func:`param_spec` of the leaf ``name`` of a parameter tree: the
    stacks ``layers/`` and ``enc_layers/`` carry a leading layer dim."""
    stacked = name.startswith(("layers/", "enc_layers/"))
    short = name.split("/", 1)[1] if stacked else name
    return param_spec(mesh, short, tuple(leaf.shape), stacked)


def params_shardings(mesh, abstract_params) -> Any:
    """Restore targets for a whole (possibly stacked) parameter tree: each
    leaf a DTensor on ``mesh`` with its :func:`param_spec`'s placements,
    the leaf's shape and dtype, and a local tensor on the ``meta``
    device (nothing is allocated)."""
    from repro_torch.checkpoint.pytree_io import flatten_named
    named, rebuild = flatten_named(abstract_params)
    return rebuild([target(mesh, leaf_spec(mesh, n, leaf), leaf)
                    for n, leaf in named])


def batch_spec(mesh, ndim: int, batch_divisible: bool = True) \
        -> PartitionSpec:
    """Shard dim 0 on the data axes (the DP rule for tokens/labels)."""
    daxes = data_axes(mesh)
    ax = daxes if len(daxes) > 1 else daxes[0]
    return P(*((ax,) + (None,) * (ndim - 1)))


def input_shardings(mesh, kind: str, cfg, shape_cfg) \
        -> Dict[str, PartitionSpec]:
    """Specs for the step inputs of a given cell kind (the reference's
    ``input_shardings``, spec by spec); :func:`placements` turns each into
    DTensor placements.  Decode: the KV caches (L, B, S, Hkv, hd) shard B
    on the data axes when they divide it, else the sequence (SP decode),
    and kv heads (else head_dim) on the model axis; SSM states shard B and
    d_inner (Mamba2: heads) likewise."""
    daxes = data_axes(mesh)
    dsize = axis_size(mesh, daxes)
    dax = daxes if len(daxes) > 1 else daxes[0]
    msize = axis_size(mesh, MODEL_AXIS)
    out: Dict[str, PartitionSpec] = {}
    B = shape_cfg.global_batch
    batch = dax if B % dsize == 0 else None

    if kind == "train":
        out["tokens"] = P(batch, None)
        out["labels"] = P(batch, None)
        if cfg.family == "vlm":
            out["patch_embeds"] = P(batch, None, MODEL_AXIS
                                    if cfg.d_model % msize == 0 else None)
        if cfg.family == "encdec":
            out["enc_embeds"] = P(batch, None, None)
        return out

    out["tokens"] = P(batch, None)
    hd, Hkv = cfg.head_dim_, cfg.n_kv_heads
    if Hkv and Hkv % msize == 0:
        kv_model_dim = 3
    elif hd % msize == 0:
        kv_model_dim = 4
    else:
        kv_model_dim = None
    kv: List[Any] = [None] * 5
    if batch is not None:
        kv[1] = dax
    else:
        kv[2] = dax          # SP: shard the cache's sequence dim
    if kv_model_dim is not None:
        kv[kv_model_dim] = MODEL_AXIS
    out["cache_k"] = P(*kv)
    out["cache_v"] = P(*kv)
    if cfg.ssm_type == "mamba1":
        # h: (L,B,di,N), conv: (L,B,K-1,di)
        out["ssm_h"] = P(None, batch,
                         MODEL_AXIS if cfg.d_inner % msize == 0 else None,
                         None)
        out["ssm_conv"] = P(None, batch, None,
                            MODEL_AXIS if cfg.d_inner % msize == 0 else None)
    elif cfg.ssm_type == "mamba2":
        # h: (L,B,H,N,P), conv: (L,B,K-1,di)
        out["ssm_h"] = P(None, batch,
                         MODEL_AXIS if cfg.ssm_heads % msize == 0 else None,
                         None, None)
        out["ssm_conv"] = P(None, batch, None,
                            MODEL_AXIS if cfg.d_inner % msize == 0 else None)
    if cfg.family == "encdec":
        out["enc_out"] = P(batch, None, None)
    return out


def replicated(mesh) -> List[Any]:
    """The placements of a tensor held whole by every rank of ``mesh``."""
    return placements(mesh, P())


# --------------------------------------------------------------------------
# Specs as DTensor placements
# --------------------------------------------------------------------------

def placements(mesh, spec: Sequence[Any]) -> List[Any]:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dim:
    ``Shard(d)`` on each mesh dim named in tensor dim d's entry,
    ``Replicate()`` on the others.  A multi-axis entry must name its
    axes in mesh order (``("data", "model")`` on a ("data", "model")
    mesh): DTensor splits a dim over its mesh dims in that order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec}: axes {missing} are not in the "
                             f"mesh's {tuple(names)}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(set(idx)):
            raise ValueError(f"spec {spec}: entry {entry!r} does not name "
                             f"its axes once each in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: axis {names[i]!r} shards "
                                 f"two dims")
            out[i] = Shard(d)
    return out


def target(mesh, spec: Sequence[Any], like) -> Any:
    """A restore target: a DTensor of ``like``'s shape and dtype on
    ``mesh`` with ``spec``'s placements, its local tensor on ``meta``."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape = tuple(like.shape)
    pl = placements(mesh, spec)
    if mesh.get_coordinate() is None:  # off the mesh: an empty block
        local_shape = tuple(0 for _ in shape)
    else:
        local_shape, _ = compute_local_shape_and_global_offset(shape, mesh,
                                                               pl)
    local = torch.empty(local_shape, dtype=like.dtype, device="meta")
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())
