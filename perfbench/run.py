"""Run one cell of the benchmark once and print its result line.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port (``src/repro_torch``).  Set-up makes the cell's inputs and
weights from ``--seed`` and warms up every shape the traffic uses;
``--trace 0`` then measures the cell's end-to-end metrics for
``--seconds`` (the window ends with the first step or request that
finishes after it), ``--trace 1`` profiles a fixed amount of the same
work and reads the cell's per-layer metrics.  After the window the
program's state is freed and the plain reference checks what the timed
path produced; the numbers compared and their limits are printed last on
stderr and under ``checks`` in the result, the last line on stdout.  The
port's kernels build into ``build/repro_torch_kernels/`` of the checkout,
once.
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench.lib import cell as cell_mod  # noqa: E402
from perfbench.lib import faults, runtime  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             fault=None, control=False):
    """Set-up, window, check: returns (result dict, checks).  ``fault``
    plants one of ``lib.faults.FAULTS`` in the program, and ``control``
    puts the control's readings in the place of the program's: the tests
    use both, the benchmark's runs neither."""
    job = cell.driver.Job(cell, seed, device)
    if fault:
        faults.plant(job, fault)
    spans = job.setup()
    setup_s = runtime.process_age_s()
    print(f"perfbench: set-up {setup_s:.3f} s, timed calls {spans}",
          file=sys.stderr)
    import torch
    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        work, tr = job.traced_window(seconds)
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        ctx = Context(cell=cell, kind=job.kind, work=work, trace=tr,
                      spans=spans, window_peak=window_peak)
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["attempted"] = len(work)
        result["breakdown"] = tr.breakdown()
    else:
        e2e, attempted, failed = job.window(seconds)
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": units[m["name"]]}
        result["attempted"], result["failed"] = attempted, failed
    peak = max(setup_peak, window_peak)
    result["device"] = runtime.device_info(device, cell.chips, peak)
    if trace:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
    job.release()
    checks = job.check(job.control() if control else None)
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    result["correct"] = bool(ok and result["failed"] == 0
                             and result["attempted"] > 0)
    return result, checks


class Context:
    """What a per-layer metric's reader reads: the cell, the work of the
    traced window (one entry a step or request: its batch B and length
    S), the trace, the set-up's timed calls and the window's peak memory."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def main(argv=None) -> int:
    args = parse(argv)
    bench = cell_mod.load_benchmark()
    cell = cell_mod.resolve(bench, args.workload)
    runtime.require_chips(cell.chips)
    import repro_torch  # noqa: F401  (the system under test must be here)
    t0 = time.perf_counter()
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = runtime.forbidden_modules()
    if found:
        sys.exit(f"perfbench: modules loaded that no run may hold: {found}")
    print(f"perfbench: {cell.name} seed {args.seed}: check and window done "
          f"{time.perf_counter() - t0:.1f} s after set-up began",
          file=sys.stderr)
    runtime.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
