"""The PyTorch port's scda layer against the JAX package's.

scda is serial-equivalent: a file's bytes depend only on the logical
content.  So the port's copied core must write the same bytes as
``repro.core`` for the same sections under any partition, the port's
``save`` of a tree of tensors must write the same file as
``repro.checkpoint.save`` of the same arrays (given the reference's vendor
string), and each package must restore the other's files bit-exactly.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.checkpoint import pytree_io as jio  # noqa: E402
from repro.configs import get_config, smoke  # noqa: E402
from repro.models import init_lm as jax_init_lm  # noqa: E402

from repro_torch import core as tcore  # noqa: E402
from repro_torch.checkpoint import manifest as tmf  # noqa: E402
from repro_torch.checkpoint import pytree_io as tio  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


# ------------------------------------------------------------ copied core --
def _sections(rng):
    """A multi-section archive's content: inline, block, arrays, varrays."""
    arr = rng.integers(0, 255, 96 * 12, dtype=np.uint8).tobytes()
    elems = [rng.integers(0, 255, int(s), dtype=np.uint8).tobytes()
             for s in rng.integers(0, 300, 13)]
    block = bytes(rng.integers(0, 255, 777, dtype=np.uint8))
    return arr, elems, block


def _write_core(core, path, P, compressed, content):
    arr, elems, block = content
    N, E = 96, 12
    counts = [N // P] * P
    counts[-1] += N - sum(counts)
    vcounts = [len(elems) // P] * P
    vcounts[-1] += len(elems) - sum(vcounts)

    def workload(comm):
        r = comm.rank
        a0 = sum(counts[:r])
        v0 = sum(vcounts[:r])
        with core.fopen_write(comm, path, b"user", b"vendor") as f:
            f.write_inline(b"status", b"x" * 32, root=0)
            f.write_block(b"blk", block if r == 0 else None,
                          E=None, root=0, encode=compressed)
            f.write_array(b"arr", arr[a0 * E:(a0 + counts[r]) * E], counts,
                          E, encode=compressed)
            f.write_varray(b"var", elems[v0:v0 + vcounts[r]], vcounts,
                           [len(e) for e in elems[v0:v0 + vcounts[r]]],
                           encode=compressed)
    core.run_ranks(core.ThreadComm.group(P), workload)


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_core_multisection_byte_identical(tmp_path, P, compressed):
    content = _sections(np.random.default_rng(P))
    ref = str(tmp_path / "ref.scda")
    port = str(tmp_path / "port.scda")
    _write_core(jcore, ref, P, compressed, content)
    _write_core(tcore, port, P, compressed, content)
    assert _read(port) == _read(ref)
    # and the port reads it back under another partition
    with tcore.fopen_read(None, port) as r:
        r.read_section_header()
        assert r.read_inline_data() == b"x" * 32


# ------------------------------------------------------------- checkpoints --
@pytest.fixture(scope="module")
def smoke_params():
    """The smoke qwen3 weights as numpy (some leaves bf16) + an aux leaf,
    and the same tree as torch tensors."""
    cfg = smoke(get_config("qwen3-1.7b"))
    jp = jax_init_lm(cfg, jax.random.PRNGKey(0))
    jp["layers"]["attn"]["wq"] = jp["layers"]["attn"]["wq"].astype(
        jnp.bfloat16)
    jp["layers"]["mlp"]["w_up"] = jp["layers"]["mlp"]["w_up"].astype(
        jnp.bfloat16)
    arrays = jax.tree_util.tree_map(np.asarray, jp)
    tree = params_from_numpy(arrays, "cpu")
    arrays["lr"] = 0.5
    tree["lr"] = 0.5
    return arrays, tree


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _bits(x):
    """The raw bytes of a tensor or (ml_dtypes) numpy array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _assert_bit_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for name in w:
        if isinstance(w[name], (float, int)):
            assert g[name] == w[name]
            continue
        assert tuple(g[name].shape) == tuple(w[name].shape), name
        assert _bits(g[name]) == _bits(w[name]), name


@pytest.mark.parametrize("window", [0, None])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_save_raw_byte_identical_to_reference(tmp_path, smoke_params, P,
                                              window):
    arrays, tree = smoke_params
    ref = str(tmp_path / "ref.scda")
    port = str(tmp_path / "port.scda")

    def workload(comm):
        jio.save(ref, arrays, step=7, comm=comm, write_window=window)
    jcore.run_ranks(jcore.ThreadComm.group(P), workload)

    def workload_t(comm):
        tio.save(port, tree, step=7, comm=comm, write_window=window,
                 vendor=tio.REFERENCE_VENDOR)
    tcore.run_ranks(tcore.ThreadComm.group(P), workload_t)
    assert _read(port) == _read(ref)


@pytest.mark.parametrize("window", [0, None])
@pytest.mark.parametrize("chunk", [1 << 12, 1 << 20])
def test_save_compressed_byte_identical_to_reference(tmp_path, smoke_params,
                                                     chunk, window):
    arrays, tree = smoke_params
    ref = str(tmp_path / "ref.scda")
    port = str(tmp_path / "port.scda")
    jio.save(ref, arrays, step=3, compressed=True, chunk_bytes=chunk,
             write_window=window)
    tio.save(port, tree, step=3, compressed=True, chunk_bytes=chunk,
             write_window=window, vendor=tio.REFERENCE_VENDOR)
    assert _read(port) == _read(ref)


def test_default_vendor_is_the_ports(tmp_path, smoke_params):
    _, tree = smoke_params
    path = str(tmp_path / "port.scda")
    tio.save(path, tree, step=1)
    head = _read(path)[:128]
    assert tio.DEFAULT_VENDOR in head and tio.REFERENCE_VENDOR not in head


@pytest.mark.parametrize("prefetch", [0, None])
@pytest.mark.parametrize("compressed", [False, True])
def test_jax_written_restores_bit_exactly_in_torch(tmp_path, smoke_params,
                                                   compressed, prefetch):
    arrays, tree = smoke_params
    path = str(tmp_path / "jax.scda")
    jio.save(path, arrays, step=11, compressed=compressed, chunk_bytes=4096)
    got, step = tio.restore(path, prefetch_bytes=prefetch)
    assert step == 11
    assert got["layers"]["attn"]["wq"].dtype == torch.bfloat16
    _assert_bit_equal(got, tree)
    like = jax.tree_util.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
        if isinstance(t, torch.Tensor) else t, tree)
    got2, _ = tio.restore(path, like=like, device="cpu",
                          prefetch_bytes=prefetch)
    assert all(t.device.type == "cpu" for _, t in _leaves(got2)
               if isinstance(t, torch.Tensor))
    _assert_bit_equal(got2, tree)


@pytest.mark.parametrize("compressed", [False, True])
def test_torch_written_restores_bit_exactly_in_jax(tmp_path, smoke_params,
                                                   compressed):
    arrays, tree = smoke_params
    path = str(tmp_path / "torch.scda")
    tio.save(path, tree, step=5, compressed=compressed, chunk_bytes=4096)
    got, step = jio.restore(path)
    assert step == 5
    assert got["layers"]["attn"]["wq"].dtype == jnp.bfloat16
    _assert_bit_equal(got, arrays)
    # restoring onto the JAX structure (like=) works too
    like = jax.eval_shape(lambda: jax.tree_util.tree_map(jnp.asarray, {
        k: v for k, v in arrays.items() if k != "lr"}))
    like["lr"] = 0.0
    got2, _ = jio.restore(path, like=like)
    _assert_bit_equal(jax.tree_util.tree_map(np.asarray, got2), arrays)


@pytest.mark.parametrize("prefetch", [0, None])
def test_restore_leaf(tmp_path, smoke_params, prefetch):
    arrays, tree = smoke_params
    path = str(tmp_path / "ck.scda")
    tio.save(path, tree, step=2)
    wq = tio.restore_leaf(path, "layers/attn/wq", prefetch_bytes=prefetch)
    assert wq.dtype == torch.bfloat16
    assert torch.equal(wq, tree["layers"]["attn"]["wq"])
    assert tio.restore_leaf(path, "lr") == 0.5
    with pytest.raises(tcore.ScdaError):
        tio.restore_leaf(path, "nope")
    assert tio.read_manifest(path)["step"] == 2


def test_restore_verify_checks_the_sidecar(tmp_path, smoke_params):
    """verify=True needs a checksummed sidecar and catches a flipped byte."""
    _, tree = smoke_params
    path = str(tmp_path / "ck.scda")
    tio.save(path, tree, step=2)
    with pytest.raises(tcore.ScdaError, match="checksummed"):
        tio.restore(path, verify=True)
    tcore.ScdaIndex.build(path).with_checksums().write_sidecar()
    got, _ = tio.restore(path, verify=True)
    _assert_bit_equal(got, tree)
    with open(path, "r+b") as fh:   # flip one payload byte near the end
        fh.seek(-100, os.SEEK_END)
        b = fh.read(1)
        fh.seek(-100, os.SEEK_END)
        fh.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(tcore.ScdaError):
        tio.restore(path, verify=True)


def test_restore_checks_target_shape(tmp_path, smoke_params):
    _, tree = smoke_params
    path = str(tmp_path / "ck.scda")
    tio.save(path, {"w": tree["embed"]})
    with pytest.raises(tcore.ScdaError, match="target shape"):
        tio.restore(path, like={"w": torch.empty(3, 3)})


@pytest.mark.parametrize("kwargs,env", [
    (dict(shards=2), {}),
    (dict(parity=1), {}),
    (dict(delta_base=({}, "base.scda")), {}),
    ({}, {"REPRO_SCDA_SHARDS": "2"}),
])
def test_layouts_not_ported_raise(tmp_path, monkeypatch, smoke_params,
                                  kwargs, env):
    _, tree = smoke_params
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    path = str(tmp_path / "ck.scda")
    with pytest.raises(NotImplementedError):
        tio.save(path, tree, **kwargs)
    assert not os.path.exists(path)


def test_sharded_reference_archive_raises(tmp_path, smoke_params):
    arrays, _ = smoke_params
    path = str(tmp_path / "set.scda")
    jio.save(path, arrays, shards=2)
    with pytest.raises(NotImplementedError, match="sharded"):
        tio.restore(path)


def test_flatten_order_matches_jax():
    tree = {"b": [torch.zeros(1), {"z": torch.zeros(2), "a": torch.zeros(3)}],
            "a": (torch.zeros(4), None, 2.0), "c": torch.zeros(())}
    named, rebuild = tio.flatten_named(tree)
    jtree = jax.tree_util.tree_map(
        lambda t: np.asarray(t) if isinstance(t, torch.Tensor) else t, tree)
    jnamed, _ = jio.flatten_named(jtree)
    assert [n for n, _ in named] == [n for n, _ in jnamed]
    back = rebuild([v for _, v in named])
    assert back["a"][1] is None and back["a"][2] == 2.0
    assert back["b"][1]["a"].shape == (3,)


@pytest.mark.parametrize("name", ["float32", "float16", "bfloat16",
                                  "float8_e4m3fn", "float8_e5m2", "int32",
                                  "int64", "int8", "uint8", "bool"])
def test_dtype_names_match_reference(name):
    from repro.checkpoint import manifest as jmf
    dt = tmf.dtype_from_name(name)
    assert tmf.dtype_name(dt) == name
    assert jmf.dtype_name(jmf.dtype_from_name(name)) == name
    assert tmf.itemsize(dt) == np.dtype(jmf.dtype_from_name(name)).itemsize
