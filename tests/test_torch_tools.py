"""The port's ``scdatool`` (``repro_torch.tools.cli``) held against the
reference's (``repro.tools.cli``) on the CPU.

Each package writes the inputs once from the same numpy arrays with the
reference's vendor, and the two sets of files must be byte-identical: the
archive of ``tests/test_cli.py`` and its eight corruptions, a flat
checkpoint and a second state, a 3 + 1 set with digests, a copy of the set
without a data shard, a delta over the flat checkpoint, a journaled
archive, and a Chrome trace of each package's ``save(trace=)`` (these two
differ in their times, so both sides get both).  Every case then runs its
commands through each package's ``main`` on a fresh copy of that
package's files: the exit codes, stdout and stderr must be equal once the
directory is masked (and ``--timing``'s wall times), and every file left
in the two directories must be byte-identical."""
import contextlib
import io
import os
import re
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))

from test_cli import CORRUPTIONS, ELEMS, V_SIZES, BLK, ARR  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.checkpoint import pytree_io as jio  # noqa: E402
from repro.journal import ScdaJournal as JJournal  # noqa: E402
from repro.tools import cli as jcli  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch.checkpoint import pytree_io as tio  # noqa: E402
from repro_torch.checkpoint import sharding as tsh  # noqa: E402
from repro_torch.journal import ScdaJournal as TJournal  # noqa: E402
from repro_torch.tools import cli as tcli  # noqa: E402

CB = 1024       # delta chunks: each leaf spans several
LOST = 1        # the degraded set's missing data shard

PACKAGES = {
    "jax": dict(core=jcore, io=jio, journal=JJournal, main=jcli.main),
    "torch": dict(core=tcore, io=tio, journal=TJournal, main=tcli.main),
}


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for name in ("REPRO_SCDA_SHARDS", "REPRO_SCDA_PARITY",
                 "REPRO_SCDA_DELTA", "REPRO_SCDA_TRACE",
                 "REPRO_SCDA_FAULTS"):
        monkeypatch.delenv(name, raising=False)


def write_archive(core, path):
    """``tests/test_cli.py``'s archive through ``core``'s writer."""
    with core.fopen_write(None, path, user_string=b"cli test") as f:
        f.write_inline(b"inl", b"#" * 32)
        f.write_block(b"blk", BLK)
        f.write_array(b"arr", ARR, [32], 8)
        f.write_varray(b"var", ELEMS, [len(ELEMS)], V_SIZES)
        f.write_block(b"zblk", BLK, encode=True)
        f.write_array(b"zarr", ARR, [64], 4, encode=True)
        f.write_varray(b"zvar", ELEMS, [len(ELEMS)], V_SIZES, encode=True)


def _arrays(seed: int):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 33)).astype(np.float32),
            "opt": {"mu": rng.standard_normal((40, 7)).astype(np.float16),
                    "count": np.arange(1000, dtype=np.int32)}}


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _save(pkg, path, arrs, **kw):
    if pkg == "jax":
        return jio.save(path, arrs, step=7, **kw)
    return tio.save(path, _tensors(arrs), step=7,
                    vendor=tio.REFERENCE_VENDOR, **kw)


def _write_inputs(pkg, d):
    p = PACKAGES[pkg]
    core = p["core"]
    write_archive(core, os.path.join(d, "a.scda"))
    for fn in CORRUPTIONS:
        path = os.path.join(d, f"bad-{fn.__name__}.scda")
        write_archive(core, path)
        data = bytearray(open(path, "rb").read())
        fn(data, core.ScdaIndex.build(path))
        with open(path, "wb") as fh:
            fh.write(bytes(data))
    state = _arrays(0)
    moved = {"w": state["w"].copy(), "opt": dict(state["opt"])}
    moved["w"][10:12] += 1.0
    flat = os.path.join(d, "flat.scda")
    _save(pkg, flat, state, record_hashes=True, chunk_bytes=CB)
    _save(pkg, os.path.join(d, "other.scda"), _arrays(1))
    _save(pkg, os.path.join(d, "delta.scda"), moved, chunk_bytes=CB,
          delta_base=(p["io"].read_manifest(flat), "flat.scda"))
    os.makedirs(os.path.join(d, "set"))
    os.makedirs(os.path.join(d, "deg"))
    for sub in ("set", "deg"):
        _save(pkg, os.path.join(d, sub, "set.scda"), state, shards=3,
              parity=1, record_hashes=True)
    os.remove(tsh.shard_file(os.path.join(d, "deg", "set.scda"), LOST, 3))
    journaled = os.path.join(d, "j.scda")
    write_archive(core, journaled)
    j = p["journal"](journaled)
    for step in range(3):
        j.log(step, {"loss": 2.0 / (step + 1), "lr": 1e-3})
    j.flush()
    write_archive(core, os.path.join(d, "nojournal.scda"))
    _save(pkg, os.path.join(d, "traced.scda"), state, shards=2, parity=1,
          trace=os.path.join(d, f"trace-{pkg}.json"))


def _tree(d):
    return {os.path.relpath(os.path.join(r, n), d): open(
        os.path.join(r, n), "rb").read()
        for r, _, names in os.walk(d) for n in names}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("scdatool")
    dirs = {}
    for pkg in PACKAGES:
        dirs[pkg] = str(root / pkg)
        os.makedirs(dirs[pkg])
        _write_inputs(pkg, dirs[pkg])
    traces = {pkg: open(os.path.join(dirs[pkg], f"trace-{pkg}.json"),
                        "rb").read() for pkg in PACKAGES}
    for pkg in PACKAGES:
        for other, data in traces.items():
            with open(os.path.join(dirs[pkg], f"trace-{other}.json"),
                      "wb") as fh:
                fh.write(data)
    return dirs


def test_both_packages_write_the_same_inputs(inputs):
    jtree, ttree = _tree(inputs["jax"]), _tree(inputs["torch"])
    assert sorted(ttree) == sorted(jtree)
    assert len(jtree) > 20
    for name in jtree:
        assert ttree[name] == jtree[name], name


#: Each case: its commands, ``{d}`` the side's directory.  Archive, then
#: checkpoints, sets, deltas, journal and trace.
CASES = {
    "ls": [["ls", "{d}/a.scda"]],
    "ls-json": [["ls", "--json", "{d}/a.scda"]],
    "ls-missing": [["ls", "{d}/nope.scda"]],
    "cat-by-name": [["cat", "{d}/a.scda", "blk"]],
    "cat-by-number": [["cat", "{d}/a.scda", "1"]],
    "cat-inline": [["cat", "{d}/a.scda", "inl"]],
    "cat-decoded": [["cat", "{d}/a.scda", "zblk"], ["cat", "{d}/a.scda",
                                                     "zarr"],
                    ["cat", "{d}/a.scda", "zvar"]],
    "cat-varray": [["cat", "{d}/a.scda", "var"]],
    "cat-element": [["cat", "{d}/a.scda", "var", "--element", "2"],
                    ["cat", "{d}/a.scda", "zvar", "--element", "3"]],
    "cat-element-on-a-block": [["cat", "{d}/a.scda", "blk", "--element",
                                "0"]],
    "cat-extent": [["cat", "{d}/a.scda", "zblk", "--extent"]],
    "cat-unknown": [["cat", "{d}/a.scda", "missing"],
                    ["cat", "{d}/a.scda", "99"]],
    "cat-leaf": [["cat", "{d}/flat.scda", "1"]],
    "fsck": [["fsck", "{d}/a.scda"]],
    "fsck-missing": [["fsck", "{d}/nope.scda"]],
    "fsck-strict-no-sidecar": [["fsck", "--strict", "--no-sidecar",
                                "{d}/a.scda", "{d}/flat.scda"]],
    "fsck-timing": [["fsck", "--timing", "{d}/a.scda"]],
    "fsck-checkpoints": [["fsck", "{d}/flat.scda", "{d}/delta.scda",
                          "{d}/set/set.scda", "{d}/j.scda"]],
    "fsck-degraded": [["fsck", "{d}/deg/set.scda"]],
    "repair-no-quarantine": [["repair", "--no-quarantine", "--no-sidecar",
                              "{d}/bad-corrupt_trailing_garbage.scda"],
                             ["repair", "{d}/nope.scda"],
                             ["fsck", "-q", "{d}/delta.scda"]],
    "repair-dry-run-degraded": [["repair", "--dry-run", "{d}/deg/set.scda"]],
    "repair-rebuild": [["repair", "--rebuild", "{d}/deg/set.scda"],
                       ["fsck", "{d}/deg/set.scda"],
                       ["verify", "--chain", "{d}/deg/set.scda"]],
    "repair-clean": [["repair", "{d}/a.scda"]],
    "index": [["index", "{d}/a.scda"], ["index", "--check", "{d}/a.scda"]],
    "index-check-without-sidecar": [["index", "--check", "{d}/a.scda"]],
    "index-checksums-verify": [["index", "--checksums", "{d}/a.scda"],
                               ["verify", "{d}/a.scda"],
                               ["verify", "--timing", "{d}/a.scda"]],
    "verify-without-sidecar": [["verify", "{d}/a.scda"]],
    "index-checksums-set": [["index", "--checksums", "{d}/set/set.scda"],
                            ["verify", "{d}/set/set.scda"]],
    "verify-degraded": [["index", "--checksums", "{d}/set/set.scda"],
                        ["verify", "{d}/deg/set.scda"]],
    "verify-chain": [["verify", "--chain", "{d}/delta.scda"],
                     ["verify", "--chain", "{d}/set/set.scda"],
                     ["verify", "--chain", "{d}/flat.scda"]],
    "copy": [["copy", "{d}/a.scda", "{d}/c.scda"],
             ["diff", "{d}/a.scda", "{d}/c.scda"]],
    "copy-recompress": [["copy", "--recompress", "--index", "{d}/a.scda",
                         "{d}/c.scda"],
                        ["diff", "{d}/a.scda", "{d}/c.scda"],
                        ["fsck", "{d}/c.scda"]],
    "copy-decompress": [["copy", "--decompress", "{d}/flat.scda",
                         "{d}/c.scda"],
                        ["diff", "--all", "{d}/flat.scda", "{d}/c.scda"],
                        ["stats", "{d}/c.scda"]],
    "diff-all": [["diff", "--all", "{d}/flat.scda", "{d}/other.scda"],
                 ["diff", "{d}/flat.scda", "{d}/other.scda"],
                 ["diff", "{d}/a.scda", "{d}/flat.scda"]],
    "diff-logical": [["diff", "--logical", "{d}/flat.scda",
                      "{d}/delta.scda"],
                     ["diff", "--logical", "{d}/flat.scda",
                      "{d}/set/set.scda"],
                     ["diff", "--logical", "{d}/flat.scda",
                      "{d}/other.scda"]],
    "squash": [["squash", "{d}/delta.scda", "{d}/sq.scda"],
               ["diff", "--logical", "{d}/delta.scda", "{d}/sq.scda"],
               ["ls", "{d}/sq.scda"]],
    "squash-index-set": [["squash", "--index", "{d}/set/set.scda",
                          "{d}/sq.scda"],
                         ["diff", "--logical", "{d}/set/set.scda",
                          "{d}/sq.scda"],
                         ["index", "--check", "{d}/sq.scda"]],
    "append": [["append", "{d}/a.scda", "{d}/flat.scda"],
               ["fsck", "{d}/a.scda"], ["ls", "{d}/a.scda"]],
    "append-recompress-index": [["append", "--recompress", "--index",
                                 "{d}/j.scda", "{d}/a.scda"],
                                ["tail", "{d}/j.scda"]],
    "append-decompress": [["index", "{d}/a.scda"],
                          ["append", "--decompress", "{d}/a.scda",
                           "{d}/j.scda"],
                          ["index", "--check", "{d}/a.scda"]],
    "append-recover": [["append", "--recover", "{d}/bad-corrupt_truncate"
                        ".scda", "{d}/a.scda"],
                       ["fsck", "{d}/bad-corrupt_truncate.scda"]],
    "append-torn-tail": [["append", "{d}/bad-corrupt_truncate.scda",
                          "{d}/a.scda"]],
    "tail": [["tail", "{d}/j.scda"]],
    "tail-no-records": [["tail", "{d}/nojournal.scda"]],
    "stats": [["stats", "{d}/a.scda", "{d}/flat.scda"]],
    "stats-json": [["stats", "--json", "{d}/a.scda", "{d}/delta.scda"]],
    "stats-set": [["stats", "{d}/set/set.scda"]],
    "stats-missing": [["stats", "{d}/nope.scda"]],
    "stats-trace-jax": [["stats", "--trace", "{d}/trace-jax.json"]],
    "stats-trace-torch": [["stats", "--trace", "{d}/trace-torch.json"]],
    "stats-trace-json": [["stats", "--json", "--trace",
                          "{d}/trace-torch.json", "{d}/traced.scda"]],
    "stats-trace-missing": [["stats", "--trace", "{d}/nope.json"]],
    "usage": [["nosuchcommand"]],
}
for _fn in CORRUPTIONS:
    _bad = f"{{d}}/bad-{_fn.__name__}.scda"
    CASES[f"fsck-q-{_fn.__name__}"] = [["fsck", "-q", _bad]]
    CASES[f"fsck-fast-{_fn.__name__}"] = [["fsck", "--fast", "-q", _bad],
                                         ["fsck", _bad]]
    CASES[f"repair-{_fn.__name__}"] = [["repair", "--dry-run", _bad],
                                       ["repair", _bad], ["fsck", _bad]]

_WALL_MS = re.compile(rb"[0-9]+\.[0-9] ms")


def _run(main, argv):
    """``(exit code, stdout, stderr)`` of one in-process call."""
    out, err = io.BytesIO(), io.BytesIO()
    so = io.TextIOWrapper(out, encoding="utf-8", write_through=True)
    se = io.TextIOWrapper(err, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        try:
            rc = main(argv)
        except SystemExit as e:     # argparse's usage errors
            rc = e.code
    so.flush()
    se.flush()
    return rc, out.getvalue(), err.getvalue()


def _side(pkg, inputs, tmp_path, commands):
    d = str(tmp_path / pkg)
    shutil.copytree(inputs[pkg], d)
    results = []
    for cmd in commands:
        rc, out, err = _run(PACKAGES[pkg]["main"],
                            [a.replace("{d}", d) for a in cmd])
        mask = d.encode()
        out, err = out.replace(mask, b"<D>"), err.replace(mask, b"<D>")
        if "--timing" in cmd:
            out = _WALL_MS.sub(b"<t> ms", out)
        results.append((rc, out, err))
    return results, _tree(d)


@pytest.mark.parametrize("case", sorted(CASES))
def test_scdatool_is_the_references(inputs, tmp_path, case):
    ref, ref_files = _side("jax", inputs, tmp_path, CASES[case])
    got, got_files = _side("torch", inputs, tmp_path, CASES[case])
    for cmd, r, g in zip(CASES[case], ref, got):
        assert g[0] == r[0], (cmd, g, r)
        assert g[1] == r[1], cmd
        assert g[2] == r[2], cmd
    assert sorted(got_files) == sorted(ref_files)
    for name, data in ref_files.items():
        assert got_files[name] == data, name


def test_the_cases_reach_every_subcommand_and_outcome():
    """Every subcommand and flag of the reference's parser appears in a
    case, and the cases exit 0 and 1 both."""
    parser = jcli.build_parser()
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    used = {c[0] for cmds in CASES.values() for c in cmds}
    flags = {a for cmds in CASES.values() for c in cmds for a in c
             if a.startswith("-")}
    for name, p in sub.choices.items():
        assert name in used, name
        for action in p._actions:
            opts = [o for o in action.option_strings if o.startswith("--")]
            if not opts or opts == ["--help"]:
                continue
            if opts[0] in ("--follow", "--interval"):
                continue    # tail -f polls forever; see the case list
            assert set(action.option_strings) & flags, (name, opts)


def test_help_runs_without_jax():
    import subprocess
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['ml_dtypes'] = None; "
            "import runpy; sys.argv = ['scdatool', '--help']; "
            "runpy.run_module('repro_torch.tools.cli', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage: scdatool")
