"""The port's parity-protected sets against the JAX package's: degraded
restores under every loss the parity covers, the refusal of a loss beyond
it, shard rebuilds byte-identical to the lost files (by the port, and by
the reference's ``scdatool repair --rebuild`` on a port-written set), and
set health classified as the reference classifies it."""
import os

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import pytree_io as jio  # noqa: E402
from repro.checkpoint import redundancy as jred  # noqa: E402
from repro.core import ScdaError as JScdaError  # noqa: E402
from repro.tools.cli import main as cli_main  # noqa: E402

from repro_torch.checkpoint import pytree_io as tio  # noqa: E402
from repro_torch.checkpoint import redundancy as tred  # noqa: E402
from repro_torch.checkpoint import sharding as tsh  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.convert import array_to_tensor  # noqa: E402
from repro_torch.core import ScdaError  # noqa: E402


def _arrays(seed):
    """Leaves of mixed dtypes and sizes (so the shards differ in length
    and the code pads the shorter streams), and an aux string."""
    rng = np.random.default_rng(seed)
    out = {f"leaf{i:02d}": rng.standard_normal(
        int(rng.integers(1, 3000))).astype(dt)
        for i, dt in enumerate((np.float32, np.float16, ml_dtypes.bfloat16,
                                np.float64, np.float32, np.float32))}
    out["ids"] = rng.integers(0, 100, 777).astype(np.int32)
    out["note"] = "hello"
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
        if isinstance(v, str):
            assert got[k] == v
        else:
            assert tuple(got[k].shape) == tuple(v.shape), k
            assert _bits(got[k]) == _bits(v), k


def _data_paths(path, doc):
    return [os.path.join(os.path.dirname(path), s["file"])
            for s in doc["shards"]]


def _parity_paths(path, doc):
    return [os.path.join(os.path.dirname(path), r["file"])
            for r in doc["parity"]["files"]]


def _read(p):
    with open(p, "rb") as fh:
        return fh.read()


def _put(p, data):
    with open(p, "wb") as fh:
        fh.write(data)


def test_gf_tables_are_the_references():
    for c in range(256):
        np.testing.assert_array_equal(tred._mul_table(c), jred._mul_table(c))
    for i in range(8):
        for j in range(2):
            assert tred._coeff(i, j) == jred._coeff(i, j)
    assert tred.MAX_PARITY == jred.MAX_PARITY == 2


@pytest.mark.parametrize("n", [2, 4, 8])
def test_every_single_shard_loss_restores_xor(tmp_path, n):
    arrays = _arrays(200 + n)
    tree = _tensors(arrays)
    path = str(tmp_path / "ck.scda")
    doc = tio.save(path, tree, step=1, shards=n, parity=1)
    paths = _data_paths(path, doc)
    originals = {p: _read(p) for p in paths}
    for lost in paths:
        os.remove(lost)
        got, step = tio.restore(path)
        assert step == 1
        _assert_bit_equal(got, tree)
        _put(lost, originals[lost])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_every_two_shard_loss_restores_rs8(tmp_path, n):
    arrays = _arrays(300 + n)
    tree = _tensors(arrays)
    path = str(tmp_path / "ck.scda")
    doc = tio.save(path, tree, step=2, shards=n, parity=2)
    paths = _data_paths(path, doc)
    originals = {p: _read(p) for p in paths}
    combos = [(a,) for a in range(n)] \
        + [(a, b) for a in range(n) for b in range(a + 1, n)]
    for combo in combos:
        for i in combo:
            os.remove(paths[i])
        got, step = tio.restore(path)
        assert step == 2, combo
        _assert_bit_equal(got, tree)
        for i in combo:
            _put(paths[i], originals[paths[i]])


def test_data_plus_parity_loss_within_budget(tmp_path):
    tree = _tensors(_arrays(5))
    path = str(tmp_path / "ck.scda")
    doc = tio.save(path, tree, step=1, shards=3, parity=2)
    os.remove(_data_paths(path, doc)[0])
    os.remove(_parity_paths(path, doc)[1])
    got, _ = tio.restore(path)
    _assert_bit_equal(got, tree)


@pytest.mark.parametrize("m", [1, 2])
def test_loss_beyond_budget_is_refused_as_the_reference_refuses(tmp_path, m):
    path = str(tmp_path / "ck.scda")
    doc = tio.save(path, _tensors(_arrays(6)), step=1, shards=4, parity=m)
    for p in _data_paths(path, doc)[:m + 1]:
        os.remove(p)
    with pytest.raises(ScdaError) as ei:
        tio.restore(path)
    with pytest.raises(JScdaError) as ej:
        jio.restore(path)
    assert ei.value.code.name == ej.value.code.name == "CORRUPT_CHECKSUM"
    assert "unrecoverable" in str(ei.value)
    assert tred.set_health(path) == jred.set_health(path)
    assert tred.set_health(path)[0] == "unrecoverable"


def test_rewritten_shard_restores_through_parity(tmp_path):
    tree = _tensors(_arrays(7))
    path = str(tmp_path / "ck.scda")
    doc = tio.save(path, tree, step=1, shards=2, parity=1)
    tio.save(_data_paths(path, doc)[0], {"other": torch.zeros(10)}, step=9)
    got, _ = tio.restore(path)
    _assert_bit_equal(got, tree)


def test_degraded_restore_leaf_and_like(tmp_path):
    tree = {"a": torch.arange(1000, dtype=torch.float32),
            "b": torch.ones((5, 5), dtype=torch.float64)}
    path = str(tmp_path / "ck.scda")
    doc = tio.save(path, tree, step=1, shards=2, parity=1)
    lost = {e["name"]: e["shard"] for e in doc["leaves"]}["a"]
    os.remove(tsh.shard_file(path, lost, 2))
    assert torch.equal(tio.restore_leaf(path, "a"), tree["a"])
    like = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}
    got, _ = tio.restore(path, like=like, device="cpu")
    _assert_bit_equal(got, tree)


@pytest.mark.parametrize("vendor", ["port", "reference"])
def test_rebuilt_shards_are_byte_identical(tmp_path, vendor):
    """Two data shards and then a parity shard, rebuilt by the port on a
    port-written set, are the lost files byte for byte; the set is clean
    after."""
    v = tio.DEFAULT_VENDOR if vendor == "port" else tio.REFERENCE_VENDOR
    path = str(tmp_path / "ck.scda")
    doc = tio.save(path, _tensors(_arrays(9)), step=3, shards=4, parity=2,
                   vendor=v)
    data = _data_paths(path, doc)
    originals = {p: _read(p) for p in data + _parity_paths(path, doc)}
    os.remove(data[1])
    os.remove(data[3])
    assert tred.set_health(path)[0] == "degraded-recoverable"
    for p in (data[1], data[3]):
        assert tred.rebuild_shard(path, doc, os.path.basename(p)) == \
            len(originals[p])
        assert _read(p) == originals[p]
    pp = _parity_paths(path, doc)[1]
    os.remove(pp)
    tred.rebuild_shard(path, doc, os.path.basename(pp))
    assert _read(pp) == originals[pp]
    assert tred.set_health(path) == ("clean", [], [])


def test_reference_repair_rebuilds_a_port_set(tmp_path):
    path = str(tmp_path / "ck.scda")
    doc = tio.save(path, _tensors(_arrays(13)), step=1, shards=3, parity=2)
    data = _data_paths(path, doc)
    originals = {p: _read(p) for p in data}
    os.remove(data[0])
    os.remove(data[2])
    assert cli_main(["repair", "--rebuild", path]) == 0
    for p in data:
        assert _read(p) == originals[p], p


@pytest.mark.parametrize("lose", ["data", "parity"])
def test_port_rebuilds_a_reference_set(tmp_path, lose):
    path = str(tmp_path / "ck.scda")
    jio.save(path, _arrays(14), step=1, shards=3, parity=2)
    doc = tsh.read_sharded_manifest(path)
    victims = (_data_paths(path, doc)[1:] if lose == "data"
               else _parity_paths(path, doc)[:1])
    originals = {p: _read(p) for p in victims}
    for p in victims:
        os.remove(p)
    for p in victims:
        tred.rebuild_shard(path, doc, os.path.basename(p))
        assert _read(p) == originals[p], p
    assert jred.set_health(path)[0] == "clean"


def test_set_health_is_classified_as_the_reference_does(tmp_path):
    path = str(tmp_path / "ck.scda")
    doc = tio.save(path, _tensors(_arrays(11)), step=1, shards=3, parity=1)
    data = _data_paths(path, doc)
    assert tred.set_health(path) == jred.set_health(path) == \
        ("clean", [], [])
    kept = _read(data[2])
    os.remove(data[2])
    assert tred.set_health(path) == jred.set_health(path)
    assert tred.set_health(path)[0] == "degraded-recoverable"
    os.remove(data[0])
    assert tred.set_health(path) == jred.set_health(path)
    assert tred.set_health(path)[0] == "unrecoverable"
    _put(data[2], kept)
    os.remove(_parity_paths(path, doc)[0])
    assert tred.set_health(path) == jred.set_health(path)
    assert tred.set_health(path)[0] == "unrecoverable"


def test_degraded_delta_chain_over_a_sharded_base(tmp_path):
    """Losing a shard of the BASE set still resolves a delta restore."""
    d = str(tmp_path / "ck")
    w1 = torch.randn(2048, generator=torch.Generator().manual_seed(8))
    w2 = w1.clone()
    w2[:4] += 1.0
    with CheckpointManager(d, keep=4, shards=2, parity=1, delta=True,
                           delta_chain=3) as mgr:
        mgr.save(1, {"w": w1}, blocking=True)
        mgr.save(2, {"w": w2}, blocking=True)
        base = sorted(n for n in os.listdir(d)
                      if n.startswith("step_0000000001-s"))
        os.remove(os.path.join(d, base[0]))
        got, step = mgr.restore_latest(device="cpu")
    assert step == 2
    assert torch.equal(got["w"], w2)


def test_multi_window_set_codes_and_solves_as_the_reference(tmp_path):
    """Shards of several 4 MiB coding windows (the port codes and solves
    windows on several threads): parity files byte-identical to the
    reference's, a two-shard loss restored, and the lost shards rebuilt
    byte for byte."""
    rng = np.random.default_rng(21)
    arrays = {"a": rng.standard_normal(2_300_001).astype(np.float32),
              "b": rng.standard_normal(2_700_000).astype(np.float32),
              "c": rng.integers(0, 255, 3_000_003, dtype=np.uint8),
              "d": rng.standard_normal(1_900_000).astype(np.float32)}
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jio.save(str(tmp_path / "j" / "ck.scda"), arrays, step=1, shards=3,
             parity=2)
    path = str(tmp_path / "t" / "ck.scda")
    doc = tio.save(path, _tensors(arrays), step=1, shards=3, parity=2,
                   vendor=tio.REFERENCE_VENDOR)
    assert max(s["bytes"] for s in doc["shards"]) > 2 * tred._STREAM_CHUNK
    for name in os.listdir(tmp_path / "j"):
        assert _read(tmp_path / "t" / name) == _read(tmp_path / "j" / name)
    data = _data_paths(path, doc)
    originals = {p: _read(p) for p in data}
    os.remove(data[0])
    os.remove(data[2])
    got, _ = tio.restore(path)
    _assert_bit_equal(got, _tensors(arrays))
    for p in (data[0], data[2]):
        tred.rebuild_shard(path, doc, os.path.basename(p))
        assert _read(p) == originals[p]
