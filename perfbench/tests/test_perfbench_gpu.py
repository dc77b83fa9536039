"""On the card: a short run of each cell through the benchmark's command,
its last line a result in the contract's form and correct.  Skips where
no card is visible (``python -m pytest -m gpu perfbench/tests`` on the
H100 machine)."""
import json
import os
import subprocess
import sys

import pytest

from perfbench.lib import cell as cell_mod

CELLS = [w["name"] for w in cell_mod.load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card(workload, tmp_path):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", "3000000017", "--seconds", "3", "--trace", "0"],
        cwd=cell_mod.ROOT, env=env, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
