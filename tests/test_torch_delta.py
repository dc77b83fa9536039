"""The port's delta checkpoints against the JAX package's: deltas written
by either package over a base written by the other, flat and sharded,
restore bit-exactly in both; the stored chunks are the reference's for the
same change; a rewritten, deleted or corrupt base is refused as the
reference refuses it; and ``squash``, ``verify_chain`` and
``checkpoint_diff`` agree with the reference's."""
import os

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.checkpoint import delta as jdelta  # noqa: E402
from repro.checkpoint import pytree_io as jio  # noqa: E402
from repro.checkpoint import sharding as jsh  # noqa: E402

from repro_torch import core as tcore  # noqa: E402
from repro_torch.checkpoint import delta as tdelta  # noqa: E402
from repro_torch.checkpoint import layout  # noqa: E402
from repro_torch.checkpoint import manifest as tmf  # noqa: E402
from repro_torch.checkpoint import pytree_io as tio  # noqa: E402
from repro_torch.checkpoint import sharding as tsh  # noqa: E402
from repro_torch.convert import array_to_tensor  # noqa: E402
from repro_torch.core.reader import fopen_read  # noqa: E402

CB = 1 << 12   # 4 KiB chunks: one edit dirties one chunk, not a leaf
REF = tio.REFERENCE_VENDOR


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((64, 48)).astype(np.float32),
        "h": rng.standard_normal((40, 64)).astype(ml_dtypes.bfloat16),
        "b": np.arange(1 << 13, dtype=np.float64),
        "m": rng.integers(0, 255, (3, 5, 7), dtype=np.uint8),
        "empty": np.zeros((0, 4), np.int32),
        "lr": 0.125,
    }


def _mutate(arrays, seed):
    """A copy with one element of ``w`` and one of ``h`` changed."""
    rng = np.random.default_rng(seed)
    out = {k: (v.copy() if isinstance(v, np.ndarray) else v)
           for k, v in arrays.items()}
    out["w"].reshape(-1)[int(rng.integers(0, out["w"].size))] += 1.0
    out["h"].reshape(-1)[int(rng.integers(0, out["h"].size))] += 1.0
    return out


def _tensors(arrays):
    return {k: array_to_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in arrays.items()}


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == v
        else:
            assert tuple(got[k].shape) == tuple(v.shape), k
            assert _bits(got[k]) == _bits(v), k


def _save(pkg, path, arrays, **kw):
    """``save`` through one package: 'jax' or 'torch' (the reference's
    vendor string, so both write the same bytes)."""
    if pkg == "jax":
        return jio.save(path, arrays, chunk_bytes=CB, **kw)
    return tio.save(path, _tensors(arrays), chunk_bytes=CB, vendor=REF, **kw)


def _base_doc(path):
    doc = tio.read_manifest(path)
    if doc.get("format") == "repro-scda-sharded":
        doc = tsh.load_set(path)
    return doc


def _read(p):
    with open(p, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("shards", [0, 3])
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("base_pkg,delta_pkg",
                         [("jax", "torch"), ("torch", "jax"),
                          ("torch", "torch")])
def test_delta_over_the_other_packages_base(tmp_path, base_pkg, delta_pkg,
                                            compressed, shards):
    a0 = _arrays(0)
    a1 = _mutate(a0, 1)
    base = str(tmp_path / "step_0000000000.scda")
    path = str(tmp_path / "step_0000000001.scda")
    _save(base_pkg, base, a0, step=0, compressed=compressed,
          record_hashes=True, shards=shards)
    _save(delta_pkg, path, a1, step=1, compressed=compressed,
          delta_base=(_base_doc(base), os.path.basename(base)),
          shards=shards)
    for prefetch in (0, None):
        got, step = tio.restore(path, prefetch_bytes=prefetch)
        assert step == 1
        _assert_bit_equal(got, _tensors(a1))
    got, _ = jio.restore(path)
    _assert_bit_equal(got, a1)
    like = {k: (torch.empty(v.shape, dtype=v.dtype, device="meta")
                if isinstance(v, torch.Tensor) else v)
            for k, v in _tensors(a1).items()}
    got, _ = tio.restore(path, like=like, device="cpu")
    _assert_bit_equal(got, _tensors(a1))
    assert _bits(tio.restore_leaf(path, "h")) == _bits(a1["h"])


@pytest.mark.parametrize("shards", [0, 2])
@pytest.mark.parametrize("compressed", [False, True])
def test_delta_bytes_and_present_lists_are_the_references(tmp_path,
                                                         compressed, shards):
    """The same change over the same base: the port's delta files are the
    reference's, so each leaf stores the same chunks."""
    a0, a1 = _arrays(3), _mutate(_arrays(3), 4)
    base = str(tmp_path / "base.scda")
    _save("jax", base, a0, step=0, compressed=compressed,
          record_hashes=True, shards=shards)
    bdoc = (jsh.load_set(base) if shards else jio.read_manifest(base))
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jdoc = jio.save(str(tmp_path / "j" / "d.scda"), a1, step=1,
                    compressed=compressed, chunk_bytes=CB,
                    delta_base=(bdoc, "base.scda"), shards=shards)
    tdoc = _save("torch", str(tmp_path / "t" / "d.scda"), a1, step=1,
                 compressed=compressed,
                 delta_base=(_base_doc(base), "base.scda"), shards=shards)
    for name in os.listdir(tmp_path / "j"):
        assert _read(tmp_path / "t" / name) == _read(tmp_path / "j" / name)
    docs = [(tdoc, jdoc)] if not shards else \
        list(zip(tdoc["shard_docs"], jdoc["shard_docs"]))
    stored = 0
    for t, j in docs:
        assert [s["present"] for s in t["leaves"]] == \
            [s["present"] for s in j["leaves"]]
        stored += sum(len(s["present"]) for s in t["leaves"])
    assert stored == 2   # one dirty chunk in w, one in h


def test_rewritten_base_is_refused(tmp_path):
    base = str(tmp_path / "step_0000000000.scda")
    path = str(tmp_path / "step_0000000001.scda")
    _save("jax", base, _arrays(0), step=0, record_hashes=True)
    _save("torch", path, _mutate(_arrays(0), 1), step=1,
          delta_base=(_base_doc(base), os.path.basename(base)))
    _save("jax", base, _arrays(99), step=0, record_hashes=True)
    with pytest.raises(tcore.ScdaError) as ei:
        tio.restore(path)
    assert ei.value.code == tcore.ScdaErrorCode.CORRUPT_CHECKSUM
    assert "rewritten" in str(ei.value)


def test_deleted_base_is_refused(tmp_path):
    base = str(tmp_path / "step_0000000000.scda")
    path = str(tmp_path / "step_0000000001.scda")
    _save("torch", base, _arrays(0), step=0, record_hashes=True)
    _save("torch", path, _mutate(_arrays(0), 1), step=1,
          delta_base=(_base_doc(base), os.path.basename(base)))
    os.remove(base)
    with pytest.raises(tcore.ScdaError) as ei:
        tio.restore(path, prefetch_bytes=0)
    with pytest.raises(jcore.ScdaError) as ej:
        jio.restore(path, prefetch_bytes=0)
    assert ei.value.code.name == ej.value.code.name
    assert os.path.basename(base) in str(ei.value)


@pytest.mark.parametrize("compressed", [False, True])
def test_corrupt_base_chunk_names_its_byte_offset(tmp_path, compressed):
    base = str(tmp_path / "step_0000000000.scda")
    path = str(tmp_path / "step_0000000001.scda")
    _save("torch", base, _arrays(0), step=0, record_hashes=True,
          compressed=compressed)
    _save("torch", path, _mutate(_arrays(0), 1), step=1,
          compressed=compressed,
          delta_base=(_base_doc(base), os.path.basename(base)))
    doc = tio.read_manifest(path)
    spec_ = next(s for s in doc["leaves"] if s["name"] == "b")
    c = len(spec_["src"]) // 2
    assert spec_["src"][c] == 1
    usizes = layout.chunk_sizes(spec_["nbytes"], CB)
    with fopen_read(None, base) as r:
        sec = r.index().find(spec_["sections"]["1"].encode("ascii"))
        e = r.index().entries[sec]
        ext, _, _ = tdelta._SrcSection(r, sec).chunk_read(
            spec_["elem"][c], usizes[c], CB, "b")
    stream = _read(base)[ext[0]:ext[0] + ext[1]]
    rel = next(k for k in range(ext[1] // 2, ext[1])
               if stream[k] not in b"\r\n")
    with open(base, "r+b") as fh:
        fh.seek(ext[0] + rel)
        fh.write(bytes([stream[rel] ^ 0xFF]))
    for prefetch in (0, None):
        with pytest.raises(tcore.ScdaError) as ei:
            tio.restore(path, prefetch_bytes=prefetch)
        assert ei.value.code.name.startswith("CORRUPT_")
        assert ei.value.offset is not None
        assert e.start <= ei.value.offset <= e.end
    with pytest.raises(jcore.ScdaError) as ej:
        jio.restore(path)
    assert ej.value.code.name == ei.value.code.name


@pytest.mark.parametrize("shards", [0, 2])
@pytest.mark.parametrize("compressed", [False, True])
def test_squash_is_a_full_save_and_the_references_squash(tmp_path,
                                                         compressed, shards):
    trees = [_arrays(0)]
    for k in (1, 2):
        trees.append(_mutate(trees[-1], k))
    paths = [str(tmp_path / f"step_{k:010d}.scda") for k in range(3)]
    for k, (p, a) in enumerate(zip(paths, trees)):
        base = (_base_doc(paths[k - 1]), os.path.basename(paths[k - 1])) \
            if k else None
        _save("torch", p, a, step=k, compressed=compressed,
              record_hashes=True, delta_base=base, shards=shards)
    tsq, jsq = str(tmp_path / "t.sq"), str(tmp_path / "j.sq")
    direct = str(tmp_path / "direct.scda")
    tdelta.squash(paths[2], tsq, vendor=REF)
    jdelta.squash(paths[2], jsq)
    _save("torch", direct, trees[2], step=2, compressed=compressed,
          record_hashes=True)
    assert _read(tsq) == _read(jsq) == _read(direct)
    got, step = tio.restore(tsq)
    assert step == 2
    _assert_bit_equal(got, _tensors(trees[2]))


def test_verify_chain_and_diff_agree_with_the_reference(tmp_path):
    trees = [_arrays(0), _mutate(_arrays(0), 1)]
    paths = [str(tmp_path / f"step_{k:010d}.scda") for k in range(2)]
    _save("torch", paths[0], trees[0], step=0, record_hashes=True)
    _save("torch", paths[1], trees[1], step=1,
          delta_base=(_base_doc(paths[0]), os.path.basename(paths[0])))
    setp = str(tmp_path / "set.scda")
    _save("torch", setp, trees[1], step=1, record_hashes=True, shards=3)
    for p in paths + [setp]:
        assert tdelta.verify_chain(p) == jdelta.verify_chain(p) == []
    for a, b in ((paths[0], paths[1]), (paths[1], setp),
                 (paths[0], setp), (paths[1], paths[1])):
        assert tdelta.checkpoint_diff(a, b) == jdelta.checkpoint_diff(a, b)
    assert tdelta.checkpoint_diff(paths[1], setp) == []
    assert any("chunks differ" in line
               for line in tdelta.checkpoint_diff(paths[0], paths[1]))
    # a flipped payload byte in the delta's own chunk of w
    doc = tio.read_manifest(paths[1])
    i = next(k for k, s in enumerate(doc["leaves"]) if s["name"] == "w")
    with fopen_read(None, paths[1]) as r:
        e = r.index().entries[r.index().find(tmf.leaf_user_string(i))]
    with open(paths[1], "r+b") as fh:
        fh.seek(e.data_start)
        b = fh.read(1)
        fh.seek(e.data_start)
        fh.write(bytes([b[0] ^ 0xFF]))
    problems = tdelta.verify_chain(paths[1])
    assert problems and problems == jdelta.verify_chain(paths[1])


def test_delta_save_requires_a_single_rank(tmp_path):
    path = str(tmp_path / "multi.scda")
    tree = _tensors(_arrays(0))

    def workload(comm):
        try:
            tio.save(path, tree, comm=comm, record_hashes=True)
            return None
        except tcore.ScdaError as err:
            comm.barrier()
            return err.code.name

    assert tcore.run_ranks(tcore.ThreadComm.group(2), workload) == \
        ["ARG_SEQUENCE", "ARG_SEQUENCE"]


def test_plan_refs_keys_on_the_strong_hash_as_the_reference_does():
    """A chunk is referenced only when its 128-bit hash matches the
    base's; its CRC32 is then inherited, and a stored chunk's CRC32 is
    computed from its bytes; a table without CRC32s and without the
    bytes to complete it is refused."""
    data = np.arange(CB, dtype=np.uint8).tobytes()
    crcs, hashes = tmf.chunk_digests(memoryview(data), [CB])
    base_leaf = tmf.LeafSpec.make("w", (CB,), torch.uint8, False, None)
    base_leaf["chunks"] = {"bytes": CB, "crc32": list(crcs),
                           "hash": list(hashes)}
    base_doc = tmf.document(0, [base_leaf], {})

    def fresh(h):
        s = tmf.LeafSpec.make("w", (CB,), torch.uint8, False, None)
        s["chunks"] = {"bytes": CB, "hash": [h]}
        return s

    for h, present, src in ((hashes[0], [], [1]),
                            ("0" * 2 * tmf.CHUNK_HASH_BYTES, [0], [0])):
        s = fresh(h)
        table = tdelta.plan_refs([s], base_doc, "base.scda",
                                 views=[memoryview(data)])
        j = fresh(h)
        jtable = jdelta.plan_refs([j], base_doc, "base.scda",
                                  views=[memoryview(data)])
        assert s["present"] == present and s["src"] == src
        assert s["chunks"]["crc32"] == list(crcs)
        assert (s, table) == (j, jtable)
    with pytest.raises(ValueError, match="no crc32"):
        tdelta.plan_refs([fresh(hashes[0])], base_doc, "base.scda")
