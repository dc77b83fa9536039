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

The ambient policy the model path reads (``set_mesh``, ``constrain``,
``padded_heads``) and the step inputs' shardings (``input_shardings``)
are not ported yet.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Sequence, Tuple


class PartitionSpec(tuple):
    """The reference's ``jax.sharding.PartitionSpec`` as a plain tuple:
    ``PartitionSpec("data", None)`` shards dim 0 on the data axis."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec

MODEL_AXIS = "model"


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
