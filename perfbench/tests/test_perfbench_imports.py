"""What the harness and the reference load: no JAX, no JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference nothing of the port."""
import json
import os
import subprocess
import sys

import pytest

from perfbench.lib import cell as cell_mod

PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
HARNESS = """
from perfbench import run
from perfbench.lib import cell, faults, readers, runtime, trace, weights
from perfbench.drivers import prefill, train
from perfbench.tools import calibrate
from perfbench.lib.cell import load_benchmark, resolve
b = load_benchmark()
for w in b["workloads"]:
    c = resolve(b, w["name"])
    for m in c.per_layer:
        c.reader(m["name"])
import repro_torch.train.step, repro_torch.serve, repro_torch.checkpoint
"""
REFERENCE = """
from perfbench.reference import adamw, model, quant
from perfbench.counts import kernels, model as counts, peaks
"""


def _loaded(imports):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = PROBE.format(root=str(cell_mod.ROOT),
                        src=str(cell_mod.ROOT / "src"), imports=imports)
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("imports", [HARNESS, REFERENCE],
                         ids=["harness", "reference"])
def test_no_jax_and_no_jax_package(imports):
    found = _loaded(imports) & {"jax", "jaxlib", "flax", "repro"}
    assert not found


def test_the_reference_imports_nothing_of_the_port():
    assert "repro_torch" not in _loaded(REFERENCE)
