"""The port's sharded checkpoint sets against the JAX package's.

A set is N shard archives, a manifest file and, with parity, m
erasure-code files.  Written by the port with the reference's vendor
string, every file of a set must be the reference's, byte for byte, for
any shard count, parity count, compression and writing partition; and
each package must restore the other's sets, whole, onto a ``like`` tree
and one leaf at a time.
"""
import os

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.checkpoint import pytree_io as jio  # noqa: E402
from repro.checkpoint import sharding as jsh  # noqa: E402

from repro_torch import core as tcore  # noqa: E402
from repro_torch.checkpoint import pytree_io as tio  # noqa: E402
from repro_torch.checkpoint import sharding as tsh  # noqa: E402
from repro_torch.convert import array_to_tensor  # noqa: E402

CB = 1 << 12   # 4 KiB chunks: each leaf spans several


def _arrays(seed=0):
    """A tree of numpy arrays as the JAX package holds them: f32, bf16,
    f16, int32, uint8, an empty and a 0-d leaf, and an aux float."""
    rng = np.random.default_rng(seed)
    return {
        "embed": rng.standard_normal((96, 40)).astype(np.float32),
        "layers": {
            "wq": rng.standard_normal((3, 24, 32)).astype(ml_dtypes.bfloat16),
            "norm": rng.standard_normal(40).astype(np.float16),
            "ids": rng.integers(-9, 9, (7, 301)).astype(np.int32)},
        "mask": rng.integers(0, 255, (5, 5, 7), dtype=np.uint8),
        "empty": np.zeros((0, 4), np.int32),
        "count": np.asarray(7, np.int32),
        "lr": 0.125,
    }


def _tensors(arrays):
    """The same tree as CPU tensors with the same bytes."""
    if isinstance(arrays, dict):
        return {k: _tensors(v) for k, v in arrays.items()}
    if isinstance(arrays, np.ndarray):
        return array_to_tensor(arrays)
    return arrays


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _assert_bit_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for name, v in w.items():
        if isinstance(v, (int, float)):
            assert g[name] == v, name
            continue
        assert tuple(g[name].shape) == tuple(v.shape), name
        assert _bits(g[name]) == _bits(v), name


def _files(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


def _meta_like(tree):
    return {k: _meta_like(v) if isinstance(v, dict) else
            (torch.empty(v.shape, dtype=v.dtype, device="meta")
             if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("m", [0, 1, 2])
@pytest.mark.parametrize("N", [1, 2, 4, 8])
def test_set_is_byte_identical_to_reference(tmp_path, N, m, compressed):
    arrays = _arrays(N + 10 * m)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jdoc = jio.save(str(tmp_path / "j" / "ck.scda"), arrays, step=4,
                    shards=N, parity=m, compressed=compressed,
                    chunk_bytes=CB)
    tdoc = tio.save(str(tmp_path / "t" / "ck.scda"), _tensors(arrays),
                    step=4, shards=N, parity=m, compressed=compressed,
                    chunk_bytes=CB, vendor=tio.REFERENCE_VENDOR)
    want = _files(tmp_path / "j")
    assert len(want) == N + m + 1
    assert _files(tmp_path / "t") == want
    assert {k: v for k, v in tdoc.items() if k != "shard_docs"} == \
        {k: v for k, v in jdoc.items() if k != "shard_docs"}


@pytest.mark.parametrize("m", [0, 1, 2])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_raw_set_under_thread_ranks_is_byte_identical(tmp_path, P, m):
    arrays = _arrays(P)
    tree = _tensors(arrays)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()

    def jwork(comm):
        jio.save(str(tmp_path / "j" / "ck.scda"), arrays, step=2, comm=comm,
                 shards=4, parity=m)
    jcore.run_ranks(jcore.ThreadComm.group(P), jwork)

    def twork(comm):
        tio.save(str(tmp_path / "t" / "ck.scda"), tree, step=2, comm=comm,
                 shards=4, parity=m, vendor=tio.REFERENCE_VENDOR)
    tcore.run_ranks(tcore.ThreadComm.group(P), twork)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


@pytest.mark.parametrize("prefetch", [0, None])
@pytest.mark.parametrize("compressed", [False, True])
def test_port_restores_a_reference_set(tmp_path, compressed, prefetch):
    arrays = _arrays(1)
    tree = _tensors(arrays)
    path = str(tmp_path / "ck.scda")
    jio.save(path, arrays, step=9, shards=3, parity=1, compressed=compressed,
             chunk_bytes=CB)
    got, step = tio.restore(path, prefetch_bytes=prefetch)
    assert step == 9
    _assert_bit_equal(got, tree)
    got, _ = tio.restore(path, like=_meta_like(tree), device="cpu",
                         prefetch_bytes=prefetch)
    assert got["layers"]["wq"].device.type == "cpu"
    _assert_bit_equal(got, tree)
    wq = tio.restore_leaf(path, "layers/wq", prefetch_bytes=prefetch)
    assert wq.dtype == torch.bfloat16
    assert _bits(wq) == _bits(tree["layers"]["wq"])
    assert tio.restore_leaf(path, "lr") == 0.125


@pytest.mark.parametrize("compressed", [False, True])
def test_reference_restores_a_port_set(tmp_path, compressed):
    arrays = _arrays(2)
    path = str(tmp_path / "ck.scda")
    tio.save(path, _tensors(arrays), step=5, shards=4, parity=2,
             compressed=compressed, chunk_bytes=CB)
    got, step = jio.restore(path)
    assert step == 5
    _assert_bit_equal(got, arrays)
    like = {k: v for k, v in arrays.items()}
    got, _ = jio.restore(path, like=like)
    _assert_bit_equal(got, arrays)
    np.testing.assert_array_equal(jio.restore_leaf(path, "embed"),
                                  arrays["embed"])


def test_read_manifest_and_tools_agree_with_reference(tmp_path):
    arrays = _arrays(3)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpath = str(tmp_path / "j" / "ck.scda")
    tpath = str(tmp_path / "t" / "ck.scda")
    jio.save(jpath, arrays, step=1, shards=3, parity=2, record_hashes=True)
    tio.save(tpath, _tensors(arrays), step=1, shards=3, parity=2,
             record_hashes=True, vendor=tio.REFERENCE_VENDOR)
    assert tio.read_manifest(tpath) == jio.read_manifest(jpath)
    for path in (jpath, tpath):
        assert tsh.verify_set(path) == jsh.verify_set(path) == []
        assert tsh.combined_document(path) == jsh.combined_document(path)
        assert tsh.summarize(path) == jsh.summarize(path)
        doc = tsh.load_set(path)
        assert tsh.chain_depth(doc) == 0 and tsh.base_usable_any(doc)
    assert tsh.assign_shards([5, 0, 9, 1, 1, 7], 3) == \
        jsh.assign_shards([5, 0, 9, 1, 1, 7], 3)
    assert tsh.shard_file("/x/ck.scda", 3, 12) == \
        jsh.shard_file("/x/ck.scda", 3, 12)
    assert tsh.is_shard_name("ck-s03of12.scda") == ("ck.scda", 3, 12)


def test_missing_shard_without_parity_is_named(tmp_path):
    path = str(tmp_path / "ck.scda")
    doc = tio.save(path, _tensors(_arrays(4)), step=1, shards=2)
    lost = doc["shards"][1]["file"]
    os.remove(tmp_path / lost)
    with pytest.raises(tcore.ScdaError) as ei:
        tio.restore(path)
    assert ei.value.code == tcore.ScdaErrorCode.FS_OPEN
    assert lost in str(ei.value)
    assert any("missing shard file" in p for p in tsh.verify_set(path))


def test_rewritten_shard_without_parity_is_refused(tmp_path):
    path = str(tmp_path / "ck.scda")
    doc = tio.save(path, _tensors(_arrays(5)), step=1, shards=2)
    victim = str(tmp_path / doc["shards"][0]["file"])
    tio.save(victim, {"other": torch.zeros(10)}, step=9)
    with pytest.raises(tcore.ScdaError) as ei:
        tio.restore(path)
    assert ei.value.code == tcore.ScdaErrorCode.CORRUPT_CHECKSUM
    assert "rewritten" in str(ei.value)


def test_knob_sets_the_shard_count(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SCDA_SHARDS", "3")
    monkeypatch.setenv("REPRO_SCDA_PARITY", "1")
    doc = tio.save(str(tmp_path / "ck.scda"), _tensors(_arrays(6)), step=1)
    assert len(doc["shards"]) == 3 and doc["parity"]["m"] == 1
    assert len(os.listdir(tmp_path)) == 5
    with pytest.raises(tcore.ScdaError):
        tio.save(str(tmp_path / "bad.scda"), _tensors(_arrays(6)),
                 shards=2, parity=3)
