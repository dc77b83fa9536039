"""The torch examples (``examples/torch_*.py``) run on the CPU, each in a
subprocess, against the reference's: the quickstart prints the reference
quickstart's lines (paths masked, and the size of its random payload) and
writes files both packages' ``scdatool fsck`` call clean; the compressed
archive's selective restore reads fewer bytes than the archive and returns
the saved leaf; the restart resumes from a checkpoint with finite losses.
Without a GPU and without ``--device cpu`` the device examples raise."""
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                JAX_PLATFORMS="cpu", **extra)


def _script(name, d, *args):
    out = subprocess.run([sys.executable, os.path.join(EXAMPLES, name),
                          *args], env=_env(SCDA_EXAMPLE_DIR=d),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return out.stdout


def _main(name, d, *args):
    """``main(args)`` of an example in a subprocess: its result (JSON)."""
    code = ("import json, runpy, sys\n"
            f"mod = runpy.run_path({os.path.join(EXAMPLES, name)!r})\n"
            f"print(json.dumps(mod['main']({list(args)!r})))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=_env(SCDA_EXAMPLE_DIR=d), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def _masked(stdout, d):
    out = stdout.replace(d, "<D>")
    return re.sub(r"^wrote \d+ bytes", "wrote <n> bytes", out, flags=re.M)


def test_quickstart_prints_the_references_lines_and_fscks_clean(tmp_path):
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    want = _masked(_script("quickstart.py", ref), ref)
    got = _masked(_script("torch_quickstart.py", port), port)
    assert got == want
    assert "serial file == 3-rank file: True" in got
    from repro.tools.cli import main as jmain
    from repro_torch.tools.cli import main as tmain
    files = sorted(os.path.join(port, n) for n in os.listdir(port))
    assert [os.path.basename(f) for f in files] == ["demo-3ranks.scda",
                                                    "demo.scda"]
    for main in (jmain, tmain):
        assert main(["fsck", *files]) == 0


def test_quickstart_main_returns_its_result(tmp_path):
    res = _main("torch_quickstart.py", str(tmp_path))
    assert res["serial_equivalent"] is True
    assert res["bytes"] == os.path.getsize(res["path"])
    assert [s[1] for s in res["sections"]] == ["status", "run config",
                                               "node coords", "cells"]


def test_compressed_archive_reads_only_the_leaf(tmp_path):
    res = _main("torch_compressed_archive.py", str(tmp_path), "--device",
                "cpu")
    assert res["exact"] and res["device"] == "cpu"
    assert res["leaf_bytes"] < res["read_bytes"] < res["packed_bytes"] / 2
    from repro_torch.checkpoint import restore, restore_leaf
    packed = os.path.join(str(tmp_path), "packed.scda")
    raw, _ = restore(os.path.join(str(tmp_path), "raw.scda"), device="cpu")
    leaf = restore_leaf(packed, res["leaf"], device="cpu")
    assert torch.equal(leaf, raw[res["leaf"]])
    # the reference reads the port's archive to the same bytes
    import numpy as np
    from repro.checkpoint import restore_leaf as jrestore_leaf
    np.testing.assert_array_equal(np.asarray(jrestore_leaf(packed,
                                                           res["leaf"])),
                                  leaf.numpy())


def test_train_restart_resumes_from_a_checkpoint(tmp_path):
    res = _main("torch_train_restart.py", str(tmp_path), "--device", "cpu",
                "--steps", "12")
    assert 0 <= res["start_step"] < res["die_at"] == 6
    assert len(res["losses"]) == 12 - res["start_step"] - 1
    assert all(x == x and abs(x) < 1e3 for x in res["losses"])
    assert res["kept"][-1] == 11


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name[:-3], os.path.join(EXAMPLES, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["torch_compressed_archive.py",
                                  "torch_train_restart.py"])
def test_device_examples_raise_without_a_gpu(monkeypatch, name, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("SCDA_EXAMPLE_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load(name).main([])
    assert not os.listdir(tmp_path)    # nothing written before the refusal
