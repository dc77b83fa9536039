"""The PyTorch port's package boundary: it imports with JAX absent, loads no
module of the JAX package, keeps its verbatim copies identical to the
reference modules (``core/trace.py`` the reference's module with the
compute path's spans added: every line of it kept, in order, and each of
its functions and classes unchanged but those it names), and runs on the
GPU unless the CPU is asked for."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
PORT_FILES = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py"))

#: Modules copied from the JAX package with only their import lines
#: rewritten (``repro.`` → ``repro_torch.``).
VERBATIM = [f"core/{m}.py" for m in (
    "errors", "spec", "partition", "trace", "faults", "io_backend", "encode",
    "codec", "index", "pipeline", "reader", "writer")] + [
    "configs/__init__.py", "configs/base.py", "configs/falcon_mamba_7b.py",
    "configs/gemma3_4b.py", "configs/granite_moe_3b_a800m.py",
    "configs/llama4_scout_17b_a16e.py", "configs/llava_next_mistral_7b.py",
    "configs/nemotron_4_15b.py", "configs/qwen3_1p7b.py",
    "configs/whisper_medium.py", "configs/yi_6b.py",
    "configs/zamba2_2p7b.py", "checkpoint/layout.py", "checkpoint/planner.py",
    "journal/__init__.py", "journal/journal.py", "tools/__init__.py",
    "tools/cli.py", "tools/fsck.py"]

#: Copies that add to the reference's module: every line of it kept, in
#: order, and every function, class and top-level assignment of it
#: unchanged but those named here, which gain whole statements (the
#: collector's compute-span state and the spans in its Chrome export).
EXTENDED = {"core/trace.py": {"TraceCollector", "TraceCollector.__init__",
                              "TraceCollector.chrome"}}

_IMPORT = re.compile(r"^(\s*)(from|import)(\s+)repro(?=[.\s])", re.M)
_FORBIDDEN = re.compile(
    r"^\s*(from|import)\s+(jax|ml_dtypes|repro)(\.|\s|$)", re.M)


def test_imports_without_jax_and_loads_no_reference_module():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [k for k in sys.modules if k == 'repro' or "
        "k.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20   # every module was imported


@pytest.mark.parametrize("rel", PORT_FILES)
def test_source_imports_no_jax_or_reference(rel):
    text = (PORT / rel).read_text()
    bad = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)]
    assert not bad, f"{rel}: {bad}"


@pytest.mark.parametrize("rel", VERBATIM)
def test_copied_module_matches_reference(rel):
    ref = (SRC / "repro" / rel).read_text()
    want = _IMPORT.sub(lambda m: f"{m.group(1)}{m.group(2)}{m.group(3)}"
                                 f"repro_torch", ref)
    got = (PORT / rel).read_text()
    if rel not in EXTENDED:
        assert got == want
        return
    lines = iter(got.splitlines())
    missing = [line for line in want.splitlines()
               if not any(line == g for g in lines)]
    assert not missing, missing[:5]
    ref_defs, port_defs = _bindings(want), _bindings(got)
    changed = [name for name, src in ref_defs.items()
               if name not in EXTENDED[rel] and port_defs.get(name) != src]
    assert not changed, changed


def _bindings(text):
    """Each name a module's top-level statements bind (its classes'
    methods as ``Class.method``) -> the sources of those statements,
    decorators included."""
    lines = text.splitlines()
    out = {}

    def add(name, node):
        first = min([node.lineno] + [d.lineno for d in getattr(
            node, "decorator_list", ())])
        out.setdefault(name, []).append(
            "\n".join(lines[first - 1:node.end_lineno]))

    def walk(body, prefix):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                add(prefix + node.name, node)
                if isinstance(node, ast.ClassDef):
                    walk(node.body, f"{prefix}{node.name}.")
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = getattr(node, "targets", None) or [node.target]
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            add(prefix + n.id, node)

    walk(ast.parse(text).body, "")
    return out


def test_comm_copy_drops_only_the_jax_communicator():
    from repro_torch.core import comm
    assert not hasattr(comm, "JaxProcessComm")
    for name in ("Communicator", "SerialComm", "ThreadComm", "run_ranks"):
        assert hasattr(comm, name)


@pytest.fixture
def no_cuda(monkeypatch):
    """Behave as on a machine without a GPU, wherever the test runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_serve_entry_point_raises_without_cuda(no_cuda):
    from repro_torch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke"])


@pytest.mark.parametrize("entry", ["init_lm", "init_cache",
                                   "params_from_numpy", "train",
                                   "launch_train"])
def test_entry_points_default_to_cuda(no_cuda, entry, tmp_path):
    import numpy as np
    from repro_torch.configs import get_config, smoke
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import train as launch
    from repro_torch.models import init_cache, init_lm
    from repro_torch.train.loop import TrainLoopConfig, train
    cfg = smoke(get_config("qwen3-1.7b"))
    ckpt = str(tmp_path / "c")
    call = {"init_lm": lambda: init_lm(cfg, 0),
            "init_cache": lambda: init_cache(cfg, 2, 8),
            "params_from_numpy": lambda: params_from_numpy(
                {"w": np.zeros(3, np.float32)}, "cuda"),
            "train": lambda: train(cfg, TrainLoopConfig(
                total_steps=2, ckpt_dir=ckpt)),
            "launch_train": lambda: launch.main([
                "--arch", "qwen3-1.7b", "--steps", "2", "--ckpt-dir",
                ckpt])}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q = torch.zeros(1, 4, 2, 16)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    assert flash_attention_cuda.launches == before


def test_kernel_build_paths_come_from_the_package():
    from repro_torch.kernels import build
    assert build.CSRC == PORT / "kernels" / "csrc"
    assert (build.CSRC / "flash_attention.cu").is_file()
    assert (build.CSRC / "ssm_scan.cu").is_file()
    assert (build.CSRC / "flash_attention_bwd.cu").is_file()
    assert build.BUILD_DIR == ROOT / "build" / "repro_torch_kernels"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
