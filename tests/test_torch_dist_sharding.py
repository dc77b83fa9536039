"""The port's parameter-placement rules (``repro_torch.distributed.sharding``)
against the JAX package's, over every arch of ``REGISTRY`` at its full
configuration.

The leaf names and shapes come from each package's own ``init_lm``: the
reference's through ``jax.eval_shape``, the port's on the ``meta``
device (nothing is drawn or allocated).  The port's meshes are
DeviceMeshes on the ``fake`` process group, so the production meshes
((16, 16) and (2, 16, 16)) build in one process; the reference's are
``jax.sharding.AbstractMesh``es of the same axes.  Every leaf's spec
must be the reference's, entry by entry, and its restore target must
carry the DTensor placements of that spec, which map back to it.
"""
import functools
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


def _spec_of(mesh, placements, ndim):
    """The spec whose ``tsh.placements`` are ``placements``: each tensor
    dim's entry names the mesh dims that shard it, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    axes = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, placements):
        if type(p) is Shard:
            axes[p.dim].append(name)
        else:
            assert isinstance(p, Replicate), p
    return tsh.P(*[None if not a else a[0] if len(a) == 1 else tuple(a)
                   for a in axes])


@pytest.fixture(scope="module", params=list(MESHES))
def meshes(request):
    """The port's DeviceMesh on a fake group of the mesh's size (torn
    down after its tests) and the reference's AbstractMesh."""
    import jax
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, names = MESHES[request.param]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        yield mesh, jax.sharding.AbstractMesh(shape, names)
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _reference_leaves(arch):
    import jax
    from repro.checkpoint.pytree_io import flatten_named
    from repro.configs import get_config
    from repro.models.lm import init_lm
    cfg = get_config(arch)
    tree = jax.eval_shape(lambda: init_lm(cfg, jax.random.PRNGKey(0)))
    return tree, [(n, tuple(v.shape)) for n, v in flatten_named(tree)[0]]


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    return init_lm(get_config(arch), 0, device="meta")


def _jax_leaves(tree):
    import jax
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))


def _cases(meshes, arch):
    """``[(name, port leaf, reference spec)]`` of ``arch``'s parameters."""
    from repro.distributed import sharding as jsh
    from repro_torch.checkpoint.pytree_io import flatten_named
    _, amesh = meshes
    ref_tree, ref_leaves = _reference_leaves(arch)
    named = flatten_named(_port_params(arch))[0]
    assert [(n, tuple(v.shape)) for n, v in named] == ref_leaves
    specs = [s.spec for s in _jax_leaves(jsh.params_shardings(amesh,
                                                              ref_tree))]
    assert len(specs) == len(named)
    return [(n, leaf, spec) for (n, leaf), spec in zip(named, specs)]


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_specs_are_the_references(meshes, arch):
    mesh, _ = meshes
    for name, leaf, want in _cases(meshes, arch):
        stacked = name.startswith(("layers/", "enc_layers/"))
        short = name.split("/", 1)[1] if stacked else name
        got = tsh.param_spec(mesh, short, tuple(leaf.shape), stacked)
        assert isinstance(got, tsh.PartitionSpec)
        assert tuple(got) == tuple(want), (arch, name, got, want)


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_params_shardings_carry_the_references_placements(meshes, arch):
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.pytree_io import flatten_named
    mesh, _ = meshes
    targets = dict(flatten_named(
        tsh.params_shardings(mesh, _port_params(arch)))[0])
    for name, leaf, want in _cases(meshes, arch):
        t = targets[name]
        assert isinstance(t, DTensor) and t.to_local().is_meta, name
        assert t.shape == leaf.shape and t.dtype == leaf.dtype, name
        assert tuple(t.placements) == tuple(tsh.placements(mesh, want)), \
            (arch, name)
        assert tuple(_spec_of(mesh, t.placements, leaf.ndim)) == \
            tuple(want), (arch, name)


def test_batch_spec_and_replicated_are_the_references(meshes):
    from torch.distributed.tensor import Replicate
    from repro.distributed import sharding as jsh
    mesh, amesh = meshes
    for ndim in (1, 2, 3):
        assert tuple(tsh.batch_spec(mesh, ndim)) == \
            tuple(jsh.batch_spec(amesh, ndim))
    assert tsh.replicated(mesh) == [Replicate()] * mesh.ndim
    assert tsh.data_axes(mesh) == jsh.data_axes(amesh)
    assert tsh.axis_size(mesh, tsh.data_axes(mesh)) == \
        jsh.axis_size(amesh, jsh.data_axes(amesh))


def test_a_multi_axis_entry_shards_one_dim_on_each_of_its_axes(meshes):
    from torch.distributed.tensor import Replicate, Shard
    mesh, _ = meshes
    names = mesh.mesh_dim_names
    spec = tsh.P(tuple(names[-2:]), None)
    want = [Replicate()] * (mesh.ndim - 2) + [Shard(0), Shard(0)]
    assert tsh.placements(mesh, spec) == want
    assert _spec_of(mesh, want, 2) == spec


@pytest.mark.parametrize("spec", [
    tsh.P(("model", "data")),          # not in mesh order
    tsh.P("data", "data"),             # one axis on two dims
    tsh.P("expert"),                   # not an axis of the mesh
    tsh.P(("data", "data")),           # one axis twice in an entry
])
def test_a_spec_placements_cannot_express_is_refused(meshes, spec):
    mesh, _ = meshes
    with pytest.raises(ValueError):
        tsh.placements(mesh, spec)
