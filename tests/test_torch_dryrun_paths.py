"""The model paths the dry-run's production meshes reach, which no other
test drives under a mesh, on spawned CPU gloo ranks against one device:
qwen3's kv projections when the model axis does not divide its kv heads
(``models.layers._heads``: each rank projects its block of every head's
dims) and falcon-mamba's decode steps under (2, 2) (``lm._ssm_decode_layers``
and ``ssm.mamba1_decode`` with their constraints).  The loss, every
gradient and three decode steps' logits within rtol = atol = 1e-5.  The
rank body is a module-level function (spawn pickles it by reference).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke  # noqa: E402


# --------------------------------------------------------------------------
# The model paths the production meshes reach, on CPU ranks
# --------------------------------------------------------------------------

#: (arch, mesh) whose loss, gradients and decode steps are held against
#: one device's: qwen3's 2 kv heads on a model axis of 4 shard the head
#: dim of wk and wv (``layers._heads`` projects each rank's block, as
#: qwen3's 8 kv heads on 16 do); falcon's decode under (2, 2) (its
#: layers' partial sums summed a layer, its gates on their shards).
MESH_PATHS = (("qwen3-1.7b", (1, 4)), ("falcon-mamba-7b", (2, 2)))
PATH_B, PATH_S, PATH_STEPS = 4, 16, 3


def _path_run(arch, mesh):
    """(loss, {name: gradient}, [decode logits]) of ``arch``'s smoke model
    from seed 0, on ``mesh`` (None: one device), all as whole numpy."""
    import numpy as np
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.pytree_io import flatten_named
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import init_lm, lm
    cfg = smoke(get_config(arch))
    params = init_lm(cfg, 0, device="cpu")
    named, rebuild = flatten_named(params)
    if mesh is not None:
        named = [(n, sh.distribute(t, mesh, sh.leaf_spec(mesh, n, t)))
                 for n, t in named]
    rng = np.random.default_rng(5)
    seq = torch.from_numpy(rng.integers(0, cfg.vocab, (PATH_B, PATH_S + 1))
                           .astype(np.int32))

    def whole(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().numpy().copy()

    leaves = [t.detach().requires_grad_(True) for _, t in named]
    tokens, labels = seq[:, :-1], seq[:, 1:].long()
    if mesh is not None:
        spec = sh.batch_spec(mesh, 2)
        tokens = sh.distribute(tokens, mesh, spec)
        labels = sh.distribute(labels, mesh, spec)
    with sh.mesh_region():
        loss = lm.lm_loss(cfg, rebuild(leaves), tokens, labels,
                          loss_chunk=8, remat=False)
        grads = torch.autograd.grad(loss, leaves)
    served = rebuild([t.detach() for _, t in named])
    cache = lm.init_cache(cfg, PATH_B, PATH_S, device="cpu", mesh=mesh)
    logits = []
    with torch.no_grad():
        for i in range(PATH_STEPS):
            got, cache = lm.serve_step(cfg, served, cache, seq[:, i:i + 1])
            logits.append(whole(got))
    return (float(whole(loss)), {n: whole(g) for (n, _), g in
                                 zip(named, grads)}, logits)


def _rank_paths():
    """Every MESH_PATHS run on 4 gloo ranks; rank 0 returns them."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import sharding as sh
    torch.set_num_threads(1)
    out = {}
    for arch, shape in MESH_PATHS:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data",
                                                              "model"))
        sh.set_mesh(mesh)
        try:
            out[arch] = _path_run(arch, mesh)
        finally:
            sh.set_mesh(None)
    return out if torch.distributed.get_rank() == 0 else None


@pytest.fixture(scope="module")
def mesh_paths():
    from repro_torch.distributed.ranks import spawn_ranks
    return spawn_ranks(_rank_paths, 4, device="cpu")[0]


@pytest.mark.parametrize("arch,shape", MESH_PATHS)
def test_the_production_meshes_paths_keep_the_function(mesh_paths, arch,
                                                       shape):
    import numpy as np
    loss, grads, logits = mesh_paths[arch]
    want_loss, want_grads, want_logits = _path_run(arch, None)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss, want_loss, **tol)
    assert sorted(grads) == sorted(want_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, want_grads[name], err_msg=name, **tol)
    for got, want in zip(logits, want_logits):
        np.testing.assert_allclose(got, want, **tol)
