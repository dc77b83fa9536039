"""Mesh-elastic scda checkpoints of DTensor state on spawned gloo ranks —
the port of ``tests/helpers/elastic_roundtrip.py``, held against the JAX
package's files.

Eight ranks (``repro_torch.distributed.ranks.spawn_ranks``, CPU) hold the
reference's train-state-like tree as DTensors and save it under the
meshes (4, 2), (2, 4) and (8, 1) with ``TorchDistComm``: each rank writes
only the windows it owns, and all three files must be
``repro.checkpoint.save``'s file of the same values.  The file then
restores under the reference's three re-partitions, fully replicated and
on one rank, with the prefetch engine and without.  Compressed files,
sets (and a set missing a data shard), a delta chain and ``restore_leaf``
restore onto placements; an uneven leaf tiles its stream once; the
reference's multi-rank refusals keep their error codes; a CheckpointManager
over the eight ranks writes the reference manager's 4 + 2 set.

The rank bodies live at module level (spawn pickles them by reference)
and this module imports no JAX at its top, so the ranks never load it.
One spawn runs every rank-side step; the tests read its results.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import layout  # noqa: E402
from repro_torch.checkpoint import pytree_io as tio  # noqa: E402
from repro_torch.distributed.ranks import spawn_ranks  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402

WORLD = 8
STEP = 11
CB = 256          # compressed and delta chunks: each leaf spans several
AXES = ("data", "model")
MESHES = {"m42": (4, 2), "m24": (2, 4), "m81": (8, 1), "m11": (1, 1)}
SAVE_MESHES = ("m42", "m24", "m81")

#: The placements the state is saved under (``make_state``'s).
SAVE_SPECS = {"params/w": P("data", "model"), "params/embed": P("model", None),
              "opt/mu": P(None, "data"), "opt/count": P()}

#: The reference's three re-partitions (``elastic_roundtrip.py:99-103``),
#: then every leaf replicated, then one rank holding the whole state.
CASES = {
    "ref-m24": ("m24", {"params/w": P("data", "model"),
                        "params/embed": P("model", None),
                        "opt/mu": P(None, "data")}),
    "ref-m81": ("m81", {"params/w": P("data", None),
                        "params/embed": P(None, "model"),
                        "opt/mu": P(None, None)}),
    "ref-m42": ("m42", {"params/w": P(("data", "model"), None),
                        "params/embed": P(), "opt/mu": P("model", None)}),
    "replicated": ("m42", {"params/w": P(), "params/embed": P(),
                           "opt/mu": P()}),
    "one-rank": ("m11", dict(SAVE_SPECS)),
}
PREFETCH = {"prefetch": None, "serial": 0}
#: Slab sizes a restore reads its block in: one span for the whole block
#: (the default, at these sizes), and a row of the first dim at a time.
SLABS = {"one": None, "rows": 1}


# --------------------------------------------------------------------------
# The state, as the reference's ``make_state`` shapes it (seeded numpy)
# --------------------------------------------------------------------------

def make_state(bump: bool = False):
    """``{params: {w, embed}, opt: {mu, count}}`` as whole CPU tensors:
    f32 (16, 32), bf16 (64, 8), f32 (16, 32) and an int32 scalar.
    ``bump`` moves two rows of ``mu`` (a delta's change)."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    mu = torch.arange(16 * 32, dtype=torch.float32).reshape(16, 32) / 512.0
    if bump:
        mu[3:5] += 1.0
    return {"params": {"w": w, "embed": e.to(torch.bfloat16)},
            "opt": {"mu": mu, "count": torch.tensor(3, dtype=torch.int32)}}


def _named(tree):
    return dict(tio.flatten_named(tree)[0])


def _rebuild_like(tree, leaves):
    named, rebuild = tio.flatten_named(tree)
    return rebuild([leaves[n] for n, _ in named])


def _bits(t) -> bytes:
    return t.detach().contiguous().reshape(-1).view(torch.uint8) \
        .numpy().tobytes()


# --------------------------------------------------------------------------
# Rank side
# --------------------------------------------------------------------------

def _shard(full, mesh, spec):
    """``full`` as a DTensor on ``mesh`` under ``spec``, each rank keeping
    its own block (no collective)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.distributed.sharding import placements
    pl = placements(mesh, spec)
    if mesh.get_coordinate() is None:
        local = full.new_empty((0,))
    else:
        lshape, off = compute_local_shape_and_global_offset(
            tuple(full.shape), mesh, pl)
        local = full[tuple(slice(o, o + n) for o, n in zip(off, lshape))]
    return DTensor.from_local(local.clone(), mesh, pl, run_check=False,
                              shape=full.shape, stride=full.stride())


def _distributed(state, mesh, specs):
    named = _named(state)
    return _rebuild_like(state, {n: _shard(v, mesh, specs.get(n, P()))
                                 for n, v in named.items()})


def _targets(state, mesh, specs):
    from repro_torch.distributed.sharding import target
    named = _named(state)
    return _rebuild_like(state, {n: target(mesh, specs.get(n, P()), v)
                                 for n, v in named.items()})


def _held(got, want, mesh, specs) -> dict:
    """Every leaf of ``got`` a DTensor with ``specs``'s placements on
    ``mesh`` whose whole value (gathered) is ``want``'s, bit for bit."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import placements
    if mesh.get_coordinate() is None:
        return {"exact": True, "placements": True}
    exact = placement_ok = True
    w = _named(want)
    for name, t in _named(got).items():
        placement_ok &= (isinstance(t, DTensor) and t.device_mesh == mesh
                         and tuple(t.placements)
                         == tuple(placements(mesh, specs.get(name, P()))))
        exact &= _bits(t.full_tensor()) == _bits(w[name])
    return {"exact": bool(exact), "placements": bool(placement_ok)}


def _chunks_of_block(full, mesh, spec, cb) -> set:
    """The chunks a rank's block of ``full`` touches, element by element
    (independent of the run decomposition)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.distributed.sharding import placements
    shape = tuple(full.shape)
    lshape, off = compute_local_shape_and_global_offset(
        shape, mesh, placements(mesh, spec))
    idx = np.arange(max(1, full.numel())).reshape(shape)[
        tuple(slice(o, o + n) for o, n in zip(off, lshape))].reshape(-1)
    size = full.element_size()
    return set((idx * size) // cb) | set((idx * size + size - 1) // cb)


def _code(fn):
    from repro_torch.core import ScdaError
    try:
        fn()
    except ScdaError as e:
        return int(e.code)
    return None


def _comm_values(comm):
    return {"bcast": comm.bcast({"root": comm.rank, "x": [1, 2]}, root=2),
            "allgather": comm.allgather((comm.rank, "r")),
            "concat": comm.allgather_concat([comm.rank] * comm.rank)}


def _elastic_rank(d: str) -> dict:
    """Every rank-side step; ``d`` holds the parent's files."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from repro_torch.checkpoint import redundancy, sharding
    from repro_torch.checkpoint.manager import snapshot_to_host
    from repro_torch.core import ScdaError
    from repro_torch.core.comm import TorchDistComm
    from repro_torch.core.reader import ScdaReader
    rank = dist.get_rank()
    comm = TorchDistComm()
    state, bumped = make_state(), make_state(bump=True)
    meshes = {k: init_device_mesh("cpu", s, mesh_dim_names=AXES)
              for k, s in MESHES.items()}
    group4 = dist.new_group([0, 1, 2, 3])
    mesh22 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                        mesh_dim_names=AXES)
    comm4 = TorchDistComm(group4) if rank < 4 else None
    out = {"rank": rank, "comm": _comm_values(comm),
           "comm4": _comm_values(comm4) if comm4 else None}

    # saves under three meshes
    for k in SAVE_MESHES:
        tio.save(os.path.join(d, f"{k}.scda"),
                 _distributed(state, meshes[k], SAVE_SPECS), comm=comm,
                 step=STEP, vendor=tio.REFERENCE_VENDOR)
    flat = os.path.join(d, "m42.scda")

    # a manager over all eight ranks writes a 4 + 2 set, and refuses what
    # the reference's ranked manager refuses
    from repro_torch.checkpoint.manager import CheckpointManager
    with CheckpointManager(os.path.join(d, "mgr"), comm=comm, shards=4,
                           parity=2, delta=False,
                           vendor=tio.REFERENCE_VENDOR) as mgr:
        mgr.save(STEP, _distributed(state, meshes["m42"], SAVE_SPECS),
                 blocking=True)
    out["manager_refusals"] = {}
    for what, kw in (("compressed", dict(compressed=True)),
                     ("delta", dict(delta=True))):
        with CheckpointManager(os.path.join(d, f"mgr-{what}"), comm=comm,
                               shards=0, **kw) as mgr:
            out["manager_refusals"][what] = _code(lambda: mgr.save(
                STEP, _distributed(state, meshes["m42"], SAVE_SPECS),
                blocking=True))

    # restores under five targets, with the prefetch engine and without
    out["restore"] = {}
    default_slab = tio.SLAB_BYTES
    for case, (mk, specs) in CASES.items():
        for pf_name, pf in PREFETCH.items():
            for slab_name, slab in SLABS.items():
                tio.SLAB_BYTES = slab or default_slab
                try:
                    got, step = tio.restore(
                        flat, _targets(state, meshes[mk], specs),
                        prefetch_bytes=pf)
                finally:
                    tio.SLAB_BYTES = default_slab
                res = _held(got, state, meshes[mk], specs)
                res["step"] = step
                out["restore"][f"{case}-{pf_name}-{slab_name}"] = res

    # a compressed file (the parent's) reads only the overlapping chunks
    mesh, specs = meshes["m24"], CASES["ref-m24"][1]
    want = sum(len(_chunks_of_block(v, mesh, specs.get(n, P()), CB))
               for n, v in _named(state).items())
    total = sum(len(layout.chunk_sizes(v.numel() * v.element_size(), CB))
                for v in _named(state).values())
    out["compressed"] = {}
    for pf_name, pf in PREFETCH.items():
        read = []
        real_run, real_elems = tio.run_pipeline, \
            ScdaReader.read_varray_elements

        def run(backend, items, window):
            read.extend(len(it.extents) for it in items if it.inflate)
            return real_run(backend, items, window)

        def elems(self, indices):
            read.append(len(indices))
            return real_elems(self, indices)

        tio.run_pipeline, ScdaReader.read_varray_elements = run, elems
        try:
            got, _ = tio.restore(os.path.join(d, "compressed.scda"),
                                 _targets(state, mesh, specs),
                                 prefetch_bytes=pf)
        finally:
            tio.run_pipeline, ScdaReader.read_varray_elements = \
                real_run, real_elems
        out["compressed"][pf_name] = dict(
            _held(got, state, mesh, specs), read=sum(read), want=want,
            total=total)

    # sets: saved by 4 ranks (N 4, m 0; and 4 + 2), then the 4 + 2 set
    # restored by all 8 onto placements after losing data shard 1
    for name, parity in (("set.scda", 0), ("pset.scda", 2)):
        if comm4 is not None:
            tio.save(os.path.join(d, name),
                     _distributed(state, mesh22, SAVE_SPECS), comm=comm4,
                     step=STEP, shards=4, parity=parity,
                     vendor=tio.REFERENCE_VENDOR)
        comm.barrier()
    pset = os.path.join(d, "pset.scda")
    lost = sharding.shard_file(pset, 1, 4)
    if rank == 0:
        os.replace(lost, lost + ".aside")
    comm.barrier()
    out["degraded"] = {}
    real_degraded = redundancy.degraded_reader
    for pf_name, pf in PREFETCH.items():
        rebuilt = []

        def degraded(path, doc, name, **kw):
            rebuilt.append(name)
            return real_degraded(path, doc, name, **kw)

        redundancy.degraded_reader = degraded
        try:
            got, step = tio.restore(pset, _targets(state, mesh, specs),
                                    prefetch_bytes=pf)
        finally:
            redundancy.degraded_reader = real_degraded
        out["degraded"][pf_name] = dict(_held(got, state, mesh, specs),
                                        rebuilt=sorted(set(rebuilt)),
                                        step=step)
    comm.barrier()
    if rank == 0:
        os.replace(lost + ".aside", lost)

    # a delta chain (the parent's, written by the JAX package)
    out["delta"] = {}
    for pf_name, pf in PREFETCH.items():
        got, step = tio.restore(os.path.join(d, "delta.scda"),
                                _targets(bumped, mesh, specs),
                                prefetch_bytes=pf)
        out["delta"][pf_name] = dict(_held(got, bumped, mesh, specs),
                                     step=step)

    # restore_leaf onto one target, from a flat file, a set and a delta
    out["restore_leaf"] = {}
    spec = P(("data", "model"), None)
    for src, path, value in (("flat", flat, state),
                             ("set", os.path.join(d, "set.scda"), state),
                             ("delta", os.path.join(d, "delta.scda"),
                              bumped)):
        leaf = _named(value)["opt/mu"]
        got = tio.restore_leaf(path, "opt/mu", like=_targets(
            {"opt": {"mu": leaf}}, mesh, {"opt/mu": spec})["opt"]["mu"])
        out["restore_leaf"][src] = _held({"opt": {"mu": got}},
                                         {"opt": {"mu": leaf}}, mesh,
                                         {"opt/mu": spec})

    # uneven leaves: their windows over the ranks tile the stream once
    uneven = torch.arange(30, dtype=torch.float32).reshape(5, 6)
    out["uneven"] = {}
    for case, m, c, spec, path in (
            ("m22", mesh22, comm4, P("data", "model"), "uneven22.scda"),
            ("m24-replicated", meshes["m24"], comm, P("model", None),
             "uneven24.scda")):
        if c is None:
            continue
        t = _shard(uneven, m, spec)
        lshape, offset, owned = tio._local_block(t)
        out["uneven"][case] = tio._block_runs(
            tuple(t.shape), lshape, offset, 4) if owned else []
        tio.save(os.path.join(d, path), {"u": t}, comm=c, step=STEP,
                 vendor=tio.REFERENCE_VENDOR)

    # the reference's refusals with comm.size > 1, and the port's own of
    # a sharded DTensor saved by one rank
    st = _distributed(state, meshes["m42"], SAVE_SPECS)
    junk = os.path.join(d, f"refused-{rank}.scda")
    out["refusals"] = {
        "compressed": _code(lambda: tio.save(junk, st, comm=comm,
                                             compressed=True)),
        "hashes": _code(lambda: tio.save(junk, st, comm=comm,
                                         record_hashes=True)),
        "delta": _code(lambda: tio.save(
            junk, st, comm=comm, delta_base=(
                tio.read_manifest(os.path.join(d, "base.scda")),
                "base.scda")))}
    out["one_rank_save"] = _code(lambda: tio.save(junk, st))

    # a full disk where rank 0 reserves the archive: every rank raises
    from repro_torch.core import faults
    with faults.inject("truncate:errno=ENOSPC:nth=2:path=full-disk"):
        try:
            tio.save(os.path.join(d, "full-disk.scda"), st, comm=comm,
                     step=STEP)
            out["full_disk"] = None
        except ScdaError as e:
            out["full_disk"] = (int(e.code), e.detail)
    if rank == 0:   # a mesh of one rank: its DTensors are whole leaves
        tio.save(os.path.join(d, "one-rank-compressed.scda"),
                 _distributed(state, meshes["m11"], SAVE_SPECS), step=STEP,
                 compressed=True, chunk_bytes=CB)
    try:
        snapshot_to_host({"opt": {"mu": st["opt"]["mu"]}})
        out["snapshot"] = None
    except ScdaError as e:
        out["snapshot"] = str(e)
    return out


# --------------------------------------------------------------------------
# Parent side
# --------------------------------------------------------------------------

def _numpy(tree):
    """The tree as the JAX package holds it: numpy, bf16 from ml_dtypes."""
    import ml_dtypes
    out = {}
    for name, t in _named(tree).items():
        if t.dtype == torch.bfloat16:
            a = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            a = t.numpy()
        out[name] = a
    return _rebuild_like(tree, out)


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """The reference's files, written here, and the ranks' results."""
    from repro.checkpoint import pytree_io as jio
    from repro.checkpoint.manager import CheckpointManager as JManager
    d = str(tmp_path_factory.mktemp("elastic"))
    ref = str(tmp_path_factory.mktemp("reference"))
    state, bumped = make_state(), make_state(bump=True)
    jio.save(os.path.join(ref, "flat.scda"), _numpy(state), step=STEP)
    with JManager(os.path.join(ref, "mgr"), shards=4, parity=2,
                  delta=False) as mgr:
        mgr.save(STEP, _numpy(state), blocking=True)
    for name, parity in (("set.scda", 0), ("pset.scda", 2)):
        jio.save(os.path.join(ref, name), _numpy(state), step=STEP,
                 shards=4, parity=parity)
    uneven = np.arange(30, dtype=np.float32).reshape(5, 6)
    jio.save(os.path.join(ref, "uneven.scda"), {"u": uneven}, step=STEP)
    tio.save(os.path.join(d, "compressed.scda"), state, step=STEP,
             compressed=True, chunk_bytes=CB)
    jio.save(os.path.join(d, "base.scda"), _numpy(state), step=STEP,
             chunk_bytes=CB, record_hashes=True)
    jio.save(os.path.join(d, "delta.scda"), _numpy(bumped), step=STEP + 1,
             chunk_bytes=CB, delta_base=(
                 jio.read_manifest(os.path.join(d, "base.scda")),
                 "base.scda"))
    results = spawn_ranks(_elastic_rank, WORLD, d, device="cpu")
    yield {"dir": d, "ref": ref, "ranks": results}
    shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("slab_bytes", [1, 40, 200, 1 << 20])
@pytest.mark.parametrize("shape,offset,lshape", [
    ((), (), ()),
    ((7,), (2,), (4,)),
    ((5, 6), (3, 3), (2, 3)),
    ((4, 6, 5), (1, 2, 0), (3, 3, 5)),
    ((3, 4, 5, 2), (0, 1, 1, 0), (3, 2, 3, 2)),
    ((6, 4), (2, 0), (0, 4)),
    ((3, 4, 5, 2), (1, 0, 0, 0), (2, 4, 5, 2)),
    ((3, 4, 5, 2), (0, 0, 0, 0), (3, 4, 5, 2)),
    ((2, 3, 4, 5, 6), (1, 1, 0, 2, 0), (1, 2, 4, 2, 6)),
])
def test_slabs_copy_the_block_out_of_its_spans(monkeypatch, shape, offset,
                                               lshape, slab_bytes):
    """Each slab's span read from the canonical bytes and copied with the
    global strides gives the block, whatever the slab size; the slabs'
    spans cover every byte of the block's runs, which are
    ``layout.shard_runs``'s."""
    monkeypatch.setattr(tio, "SLAB_BYTES", slab_bytes)
    rng = np.random.default_rng(5)
    full = rng.standard_normal(shape).astype(np.float32)
    raw = full.tobytes()
    arr = np.zeros(int(np.prod(lshape)) * 4, np.uint8)
    slabs = tio._block_slabs(shape, lshape, offset, 4)
    for i0, i1, start, n in slabs:
        dst, src = tio._slab_views(
            arr, np.frombuffer(raw[start:start + n], np.uint8), shape,
            lshape, 4, (i0, i1))
        dst[...] = src
    block = full[tuple(slice(o, o + n) for o, n in zip(offset, lshape))]
    assert arr.tobytes() == np.ascontiguousarray(block).tobytes()
    runs = tio._block_runs(shape, lshape, offset, 4)
    assert runs == layout.shard_runs(
        shape, tuple(slice(o, o + n) for o, n in zip(offset, lshape)), 4)
    covered = np.zeros(len(raw) or 4, bool)
    for _, _, start, n in slabs:
        covered[start:start + n] = True
    for g, _, n in runs:
        assert covered[g:g + n].all(), (g, n)


@pytest.mark.parametrize("slab_bytes", [1, 40, 1 << 20])
@pytest.mark.parametrize("shape,split", [
    ((), ()), ((7,), (3,)), ((5, 6), (2, 4)), ((4, 6, 5), (3, 2, 2)),
    ((3, 4, 5, 2), (2, 3, 1, 2)),
    ((64, 40), (16, 24)),   # blocks that start pages past the section's
])
def test_blocks_mapped_into_a_section_give_its_canonical_bytes(
        monkeypatch, tmp_path, shape, split, slab_bytes):
    """Blocks that tile a tensor, each copied into a mapping of a
    pre-sized file at a section offset that is not page-aligned, leave the
    tensor's canonical bytes there and nothing else changed."""
    from itertools import product
    from repro_torch.core.io_backend import FileBackend
    monkeypatch.setattr(tio, "SLAB_BYTES", slab_bytes)
    rng = np.random.default_rng(6)
    full = rng.standard_normal(shape).astype(np.float32)
    path, data_start = str(tmp_path / "f"), 4099
    with open(path, "wb") as fh:
        fh.write(b"\xab" * (data_start + full.nbytes + 5))
    backend = FileBackend(path, "w", create=False)
    edges = [sorted({0, d} | set(range(0, d, s))) + [d]
             for d, s in zip(shape, split)]
    for idx in product(*(range(len(e) - 2) for e in edges)):
        offset = tuple(e[i] for e, i in zip(edges, idx))
        lshape = tuple(e[i + 1] - e[i] for e, i in zip(edges, idx))
        block = full[tuple(slice(o, o + n) for o, n in zip(offset, lshape))]
        tio._map_block(backend, data_start, shape, 4, lshape, offset,
                       np.ascontiguousarray(block).reshape(-1).view(np.uint8))
    backend.close()
    got = _read(path)
    assert got[:data_start] == b"\xab" * data_start
    assert got[data_start:data_start + full.nbytes] == full.tobytes()
    assert got[data_start + full.nbytes:] == b"\xab" * 5


def _files(d, stem):
    return sorted(f for f in os.listdir(d)
                  if f.startswith(stem) and f.endswith(".scda"))


@pytest.mark.parametrize("mesh", SAVE_MESHES)
def test_save_under_a_mesh_is_the_references_file(elastic, mesh):
    got = _read(os.path.join(elastic["dir"], f"{mesh}.scda"))
    assert got == _read(os.path.join(elastic["ref"], "flat.scda"))


@pytest.mark.parametrize("slab", SLABS)
@pytest.mark.parametrize("pf", PREFETCH)
@pytest.mark.parametrize("case", CASES)
def test_restore_onto_placements_is_exact(elastic, case, pf, slab):
    for r in elastic["ranks"]:
        res = r["restore"][f"{case}-{pf}-{slab}"]
        assert res["step"] == STEP, r["rank"]
        assert res["exact"], (r["rank"], case, pf)


@pytest.mark.parametrize("pf", PREFETCH)
@pytest.mark.parametrize("case", CASES)
def test_restore_gives_the_requested_placements(elastic, case, pf):
    for r in elastic["ranks"]:
        for slab in SLABS:
            assert r["restore"][f"{case}-{pf}-{slab}"]["placements"], \
                (r["rank"], case)


@pytest.mark.parametrize("pf", PREFETCH)
def test_compressed_restore_reads_only_the_overlapping_chunks(elastic, pf):
    for r in elastic["ranks"]:
        res = r["compressed"][pf]
        assert res["exact"] and res["placements"], r["rank"]
        assert res["read"] == res["want"], (r["rank"], res)
        assert res["read"] < res["total"], (r["rank"], res)


@pytest.mark.parametrize("stem", ["set", "pset"])
def test_set_saved_by_four_ranks_is_the_references(elastic, stem):
    names = _files(elastic["ref"], stem + ".") + \
        _files(elastic["ref"], stem + "-")
    assert len(names) == {"set": 5, "pset": 7}[stem]
    assert names == _files(elastic["dir"], stem + ".") + \
        _files(elastic["dir"], stem + "-")
    for name in names:
        assert _read(os.path.join(elastic["dir"], name)) == \
            _read(os.path.join(elastic["ref"], name)), name


def test_a_manager_on_eight_ranks_writes_the_reference_managers_set(
        elastic):
    """Each rank writes the blocks it owns of a DTensor state into the
    set's files and rank 0 commits: every file, sidecars included, is the
    reference manager's."""
    ref, got = (os.path.join(elastic[k], "mgr") for k in ("ref", "dir"))
    names = sorted(os.listdir(ref))
    assert len(names) == 14   # manifest, 4 shards, 2 parity; sidecars
    assert sorted(os.listdir(got)) == names
    for name in names:
        assert _read(os.path.join(got, name)) == \
            _read(os.path.join(ref, name)), name


@pytest.mark.parametrize("what", ["compressed", "delta"])
def test_a_ranked_manager_refuses_what_the_reference_refuses(elastic, what,
                                                             tmp_path):
    """The reference's manager on 2 ThreadComm ranks gives the code."""
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.core import ScdaError as JScdaError
    from repro.core.comm import ThreadComm, run_ranks
    kw = dict(compressed=True) if what == "compressed" else dict(delta=True)

    def body(c):
        with JManager(str(tmp_path), comm=c, shards=0, **kw) as mgr:
            try:
                mgr.save(STEP, _numpy(make_state()), blocking=True)
            except JScdaError as e:
                return int(e.code)
    want, = set(run_ranks(ThreadComm.group(2), body))
    assert want is not None
    for r in elastic["ranks"]:
        assert r["manager_refusals"][what] == want, r["rank"]


@pytest.mark.parametrize("pf", PREFETCH)
def test_set_without_a_data_shard_restores_onto_placements(elastic, pf):
    for r in elastic["ranks"]:
        res = r["degraded"][pf]
        assert res["exact"] and res["placements"] and res["step"] == STEP
        assert res["rebuilt"] == ["pset-s01of04.scda"], res


@pytest.mark.parametrize("pf", PREFETCH)
def test_delta_chain_restores_onto_placements(elastic, pf):
    for r in elastic["ranks"]:
        res = r["delta"][pf]
        assert res["exact"] and res["placements"], r["rank"]
        assert res["step"] == STEP + 1


@pytest.mark.parametrize("src", ["flat", "set", "delta"])
def test_restore_leaf_onto_a_placement(elastic, src):
    for r in elastic["ranks"]:
        res = r["restore_leaf"][src]
        assert res["exact"] and res["placements"], r["rank"]


@pytest.mark.parametrize("case,world", [("m22", 4), ("m24-replicated", 8)])
def test_uneven_leaf_tiles_its_stream_once(elastic, case, world):
    runs = [r["uneven"][case] for r in elastic["ranks"][:world]]
    assert layout.runs_cover_exactly(runs, 5 * 6 * 4)
    assert sum(1 for rs in runs if rs) < world or case == "m22"
    path = {"m22": "uneven22.scda", "m24-replicated": "uneven24.scda"}[case]
    assert _read(os.path.join(elastic["dir"], path)) == \
        _read(os.path.join(elastic["ref"], "uneven.scda"))


def _reference_codes(tmp_path):
    """The reference's codes for the same saves on 2 ThreadComm ranks."""
    from repro.checkpoint import pytree_io as jio
    from repro.core import ScdaError as JScdaError
    from repro.core.comm import ThreadComm, run_ranks
    tree = _numpy(make_state())
    base = str(tmp_path / "base.scda")
    jio.save(base, tree, record_hashes=True)
    kws = {"compressed": dict(compressed=True),
           "hashes": dict(record_hashes=True),
           "delta": dict(delta_base=(jio.read_manifest(base),
                                     "base.scda"))}
    codes = {}
    for name, kw in kws.items():
        def body(c, kw=kw):
            try:
                jio.save(str(tmp_path / f"x{c.rank}.scda"), tree, comm=c,
                         **kw)
            except JScdaError as e:
                return int(e.code)
        codes[name] = run_ranks(ThreadComm.group(2), body)
    return codes


@pytest.mark.parametrize("what", ["compressed", "hashes", "delta"])
def test_multi_rank_refusals_keep_the_references_codes(elastic, tmp_path,
                                                       what):
    want = _reference_codes(tmp_path)[what]
    assert want[0] is not None and len(set(want)) == 1
    for r in elastic["ranks"]:
        assert r["refusals"][what] == want[0], (r["rank"], what)


def test_parity_with_several_ranks_is_written_as_the_reference_writes_it(
        elastic):
    """The reference does not refuse parity with comm.size > 1 (rank 0
    writes it and broadcasts its record): the port's 4-rank 4 + 2 set is
    the reference's, parity files included."""
    for name in ("pset-p00of02.scda", "pset-p01of02.scda"):
        assert _read(os.path.join(elastic["dir"], name)) == \
            _read(os.path.join(elastic["ref"], name))


def test_one_rank_save_of_a_sharded_dtensor_is_refused(elastic):
    from repro_torch.core import ScdaErrorCode
    for r in elastic["ranks"]:
        assert r["one_rank_save"] == int(ScdaErrorCode.ARG_SEQUENCE)


def test_a_full_disk_fails_a_dtensor_save_on_every_rank(elastic):
    """ENOSPC when rank 0 reserves the archive's blocks is FS_WRITE on
    every rank, before any block is copied into a mapping of the file."""
    from repro_torch.core import ScdaErrorCode
    for r in elastic["ranks"]:
        assert r["full_disk"] is not None, r["rank"]
        code, detail = r["full_disk"]
        assert code == int(ScdaErrorCode.FS_WRITE), r["rank"]
        assert "NO SPACE LEFT ON DEVICE" in detail, r["rank"]
        assert detail.startswith("rank 0: ") == (r["rank"] != 0)


@pytest.mark.parametrize("errno_", ["ENOSPC", "EIO"])
@pytest.mark.parametrize("where", ["truncate", "fallocate"])
def test_reserving_an_archive_maps_its_errors(monkeypatch, tmp_path, where,
                                               errno_):
    """A failed extension or allocation of the archive is FS_WRITE naming
    the file: the truncate through the backend's fault plan, the
    allocation as the OS would fail it."""
    import errno
    from repro_torch.core import ScdaError, ScdaErrorCode
    from repro_torch.core.faults import FaultBackend
    from repro_torch.core.io_backend import FileBackend
    path = str(tmp_path / "f")
    num = getattr(errno, errno_)
    if where == "truncate":
        backend = FaultBackend(path, "w", True, f"truncate:errno={errno_}")
    else:
        def fail(fd, offset, n):
            raise OSError(num, os.strerror(num))
        monkeypatch.setattr(tio.os, "posix_fallocate", fail)
        backend = FileBackend(path, "w", True)
    try:
        with pytest.raises(ScdaError) as e:
            tio._reserve(backend, 12345)
        assert e.value.code == ScdaErrorCode.FS_WRITE
        assert path in e.value.detail
    finally:
        backend.close()


def test_reserving_an_archive_allocates_its_blocks(tmp_path):
    from repro_torch.core.io_backend import FileBackend
    path = str(tmp_path / "f")
    backend = FileBackend(path, "w", True)
    try:
        tio._reserve(backend, 1 << 20)
        st = os.fstat(backend.fd)
        assert st.st_size == 1 << 20 and st.st_blocks * 512 >= 1 << 20
    finally:
        backend.close()


def test_dtensors_on_a_one_rank_mesh_save_compressed_as_tensors(elastic):
    assert _read(os.path.join(elastic["dir"],
                              "one-rank-compressed.scda")) == \
        _read(os.path.join(elastic["dir"], "compressed.scda"))


@pytest.mark.parametrize("group", ["world", "first four"])
def test_torch_dist_comm_matches_thread_comm(elastic, group):
    from repro_torch.core.comm import ThreadComm, run_ranks
    n, key = (WORLD, "comm") if group == "world" else (4, "comm4")
    want = run_ranks(ThreadComm.group(n), _comm_values)
    assert [r[key] for r in elastic["ranks"][:n]] == want


def test_snapshot_to_host_refuses_a_dtensor_leaf(elastic):
    for r in elastic["ranks"]:
        assert r["snapshot"] is not None and "opt/mu" in r["snapshot"]
        assert "single-process" in r["snapshot"]
