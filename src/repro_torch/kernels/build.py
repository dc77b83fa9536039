"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and no PyTorch headers, so
it compiles in seconds.  The shared library goes to
``build/repro_torch_kernels/`` at the root of the checkout (found from this
file's path, not the working directory), named by a hash of the source and
the flags, so an edited source is never served a stale library.  Nothing
is built when a module is imported: the first launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: Hopper only: ``sm_90a`` keeps the architecture-specific instructions
#: (wgmma, setmaxnreg) open to later kernels.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

#: source name -> (library, seconds spent building it in this process, log)
_LOADED: Dict[str, Tuple[ctypes.CDLL, float, str]] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(sources: List[str]) -> Dict[str, Tuple[Path, str]]:
    """Compile every source not yet built, one ``nvcc`` each, all started
    together.  Returns ``{source: (library path, compiler log)}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, Tuple[Path, str]] = {}
    for source in sources:
        lib = library_path(source)
        if lib.exists():
            out[source] = (lib, "")
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        procs[source] = (lib, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for source, (lib, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
        out[source] = (lib, log)
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    if source not in _LOADED:
        t0 = time.perf_counter()
        lib, log = build([source])[source]
        _LOADED[source] = (ctypes.CDLL(str(lib)), time.perf_counter() - t0,
                           log)
    return _LOADED[source][0]


def build_report(source: str) -> Tuple[float, str]:
    """(seconds spent building and loading ``source``, compiler log)."""
    _, seconds, log = _LOADED[source]
    return seconds, log
