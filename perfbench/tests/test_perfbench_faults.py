"""A whole run past the look for a chip, at a size the CPU holds: sound,
it comes out correct; with the timed path broken underneath (each fault
the cell can have, ``lib.faults``) or with the control in the program's
place (the reference with float8 products), ``correct`` comes out
false.

The program runs in float32 here (the port's plain versions), so a sound
run reads rounding alone.  The readings scale with the model's widths
(a logit gap with the logits' spread), so runs are held to the limits of
this size (``tiny.LIMITS``), which sound runs pass."""
import pytest

from perfbench.run import run_cell
from perfbench.tests import tiny
from perfbench.lib import cell as cell_mod
from perfbench.lib.faults import FAULTS

CELLS = [w["name"] for w in cell_mod.load_benchmark()["workloads"]]
SEED = 2**31 + 12345          # a benchmark seed may pass 32 signed bits


def _run(workload, limits=None, **kw):
    result, checks = run_cell(tiny.cell(workload, limits), SEED, 0.05, False,
                              device="cpu", **kw)
    return result, {n: (v, lim) for n, v, lim in checks}


@pytest.mark.parametrize("limits", [None, "tiny"], ids=["cell", "tiny"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload, limits):
    result, checks = _run(workload, limits)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) >= {"setup_s"}
    assert result["device"]["platform"] == "cpu"


FAULTY = [(w, f) for w in CELLS
          for f in FAULTS[tiny.cell(w).driver.Job.kind]]


@pytest.mark.parametrize("workload,fault", FAULTY,
                         ids=[f"{w}-{f}" for w, f in FAULTY])
def test_a_fault_is_caught(workload, fault):
    result, checks = _run(workload, "tiny", fault=fault)
    assert not result["correct"], checks


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    result, checks = _run(workload, "tiny", control=True)
    assert not result["correct"], checks
