"""The port's ``save(..., trace=)`` and its trace records, held against the
JAX package's on the same numpy arrays.

A traced save (a ``TraceCollector`` or a path that gets a Chrome trace)
writes the bytes of an untraced one, for flat files, sets and deltas, and
its trace holds the reference's multiset of span names and categories.  A
restore's records equal the reference's as a multiset per file, for flat,
set, compressed and degraded restores; the port may add ``io/preadv``
records of parity files in a degraded restore (it reads parity through
positioned reads without the shared read cache, so that windows read in
parallel), and the ``restore.in_flight_*`` gauges' values follow thread
timing."""
import collections
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import pytree_io as jio  # noqa: E402
from repro.core import trace as jtrace  # noqa: E402

from repro_torch.checkpoint import pytree_io as tio  # noqa: E402
from repro_torch.checkpoint import redundancy as tred  # noqa: E402
from repro_torch.checkpoint import sharding as tsh  # noqa: E402
from repro_torch.checkpoint.pytree_io import REFERENCE_VENDOR  # noqa: E402
from repro_torch.core import trace as ttrace  # noqa: E402

CB = 1024   # compressed and delta chunks: each leaf spans several

#: Save layouts: keyword arguments of both packages' ``save``.
LAYOUTS = {
    "flat": {},
    "compressed": dict(compressed=True, chunk_bytes=CB),
    "set": dict(shards=3, parity=1, record_hashes=True),
    "delta": dict(record_hashes=True, chunk_bytes=CB),
}


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for name in ("REPRO_SCDA_SHARDS", "REPRO_SCDA_PARITY",
                 "REPRO_SCDA_DELTA", "REPRO_SCDA_TRACE",
                 "REPRO_SCDA_FAULTS"):
        monkeypatch.delenv(name, raising=False)


def _arrays(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 33)).astype(np.float32),
            "opt": {"mu": rng.standard_normal((40, 7)).astype(np.float16),
                    "count": np.arange(1000, dtype=np.int32)}}


def _bump(arrs):
    out = {"w": arrs["w"].copy(), "opt": dict(arrs["opt"])}
    out["w"][10:12] += 1.0
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _save(pkg, path, arrs, **kw):
    if pkg == "jax":
        return jio.save(path, arrs, step=3, **kw)
    return tio.save(path, _tensors(arrs), step=3, vendor=REFERENCE_VENDOR,
                    **kw)


def _save_layout(pkg, d, layout, **trace):
    """The layout's checkpoint of ``_arrays()`` in ``d``, as ``ckpt.scda``
    (a delta over ``base.scda``, saved untraced first)."""
    kw = dict(LAYOUTS[layout])
    arrs = _arrays()
    if layout == "delta":
        base = os.path.join(d, "base.scda")
        _save(pkg, base, arrs, **kw)
        read = jio.read_manifest if pkg == "jax" else tio.read_manifest
        kw["delta_base"] = (read(base), "base.scda")
        arrs = _bump(arrs)
    _save(pkg, os.path.join(d, "ckpt.scda"), arrs, **kw, **trace)


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith(".scda")}


def _records(trace_mod, path):
    """Every record of a Chrome trace as ``(ph, cat, name, args)``, each
    path by its base name and the in-flight gauges' values masked."""
    out = []
    for ev in trace_mod.load_chrome(path):
        args = {k: (os.path.basename(v) if k == "path" else v)
                for k, v in (ev.get("args") or {}).items()}
        if ev["name"].startswith("restore.in_flight"):
            args = {k: "*" for k in args}
        out.append((ev.get("ph"), ev["cat"], ev["name"],
                    json.dumps(args, sort_keys=True)))
    return out


def _by_file(records):
    """Records grouped by the file they name (``None``: no file)."""
    out = collections.defaultdict(collections.Counter)
    for r in records:
        out[json.loads(r[3]).get("path")][r] += 1
    return dict(out)


@pytest.mark.parametrize("how", ["path", "collector"])
@pytest.mark.parametrize("layout", ["flat", "set", "delta"])
def test_traced_save_writes_the_untraced_bytes(tmp_path, layout, how):
    plain, traced = tmp_path / "plain", tmp_path / "traced"
    plain.mkdir()
    traced.mkdir()
    _save_layout("torch", str(plain), layout)
    json_path = str(tmp_path / "trace.json")
    tc = ttrace.TraceCollector(path=json_path)
    _save_layout("torch", str(traced), layout,
                 trace=json_path if how == "path" else tc)
    assert _files(str(traced)) == _files(str(plain))
    if how == "path":
        assert os.path.exists(json_path)
        names = {e["name"] for e in ttrace.load_chrome(json_path)}
    else:
        names = {e["name"] for e in tc.chrome()["traceEvents"]}
    assert "save" in names
    assert ttrace.collector() is None   # the scope ends with the save


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_save_trace_holds_the_references_spans(tmp_path, layout):
    counts = {}
    for pkg, mod in (("jax", jtrace), ("torch", ttrace)):
        d = tmp_path / pkg
        d.mkdir()
        path = str(tmp_path / f"{pkg}.json")
        _save_layout(pkg, str(d), layout, trace=path)
        counts[pkg] = collections.Counter(
            (e["cat"], e["name"]) for e in mod.load_chrome(path))
    assert counts["torch"] == counts["jax"]
    assert counts["jax"][("ckpt", "save")] == 1


def test_save_trace_is_the_references_export(tmp_path):
    """The exported files differ only in times and ids: the same records,
    file by file."""
    recs = {}
    for pkg, mod in (("jax", jtrace), ("torch", ttrace)):
        d = tmp_path / pkg
        d.mkdir()
        path = str(tmp_path / f"{pkg}.json")
        _save_layout(pkg, str(d), "set", trace=path)
        recs[pkg] = _by_file(_records(mod, path))
    assert recs["torch"] == recs["jax"]


def _restore_records(pkg, d, lost):
    """The restore's records of ``d/ckpt.scda`` after deleting the data
    shards ``lost``."""
    path = os.path.join(d, "ckpt.scda")
    for k in lost:
        os.remove(tsh.shard_file(path, k, 3))
    mod, io = (jtrace, jio) if pkg == "jax" else (ttrace, tio)
    out = os.path.join(d, "restore.json")
    tc = mod.install(mod.TraceCollector(path=out))
    try:
        got, step = io.restore(path)
    finally:
        mod.uninstall()
    tc.export()
    assert step == 3
    return _by_file(_records(mod, out)), got


RESTORES = {"flat": ("flat", ()), "set": ("set", ()),
            "compressed": ("compressed", ()),
            "degraded-1": ("parity2", (1,)), "degraded-2": ("parity2",
                                                            (0, 2))}


@pytest.mark.parametrize("case", sorted(RESTORES))
def test_restore_records_are_the_references_per_file(tmp_path, case):
    layout, lost = RESTORES[case]
    kw = (dict(shards=3, parity=2) if layout == "parity2"
          else LAYOUTS[layout])
    recs, values = {}, {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        _save(pkg, str(d / "ckpt.scda"), _arrays(), **kw)
        recs[pkg], values[pkg] = _restore_records(pkg, str(d), lost)
    jrec, trec = recs["jax"], recs["torch"]
    parity_reads = 0
    for f in sorted(set(jrec) | set(trec), key=str):
        extra = trec.get(f, collections.Counter()) - jrec.get(
            f, collections.Counter())
        missing = jrec.get(f, collections.Counter()) - trec.get(
            f, collections.Counter())
        assert not missing, (f, missing)
        if f and tred.is_parity_name(f) and lost:
            # The port's positioned parity reads, one a window a row.
            assert all(r[1:3] == ("io", "preadv") for r in extra), extra
            parity_reads += sum(extra.values())
        else:
            assert not extra, (f, extra)
    assert parity_reads >= len(lost)
    np.testing.assert_array_equal(values["torch"]["w"].numpy(),
                                  values["jax"]["w"])
