"""The readings the limits of ``cells/<cell>.json`` are set from, on the chip
at the cell's own size, many seeds in one process (the benchmark's own
runs never run this).

    python perfbench/tools/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --mode program|control|fault:<name>|size [--seconds 10] \\
        [--batch B] [--out FILE]

``program`` reads what a sound run compares; ``control`` puts the
reference computed with float8 products in the program's place;
``fault:<name>`` plants one of ``lib.faults.FAULTS`` in the program;
``size`` runs the training step at batch 1, 2, 4, ... and reads its
peak memory (``--batch`` caps it).  One JSON line a seed (or a batch) goes
to ``--out`` and to stdout.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from perfbench.lib import cell as cell_mod  # noqa: E402
from perfbench.lib import faults  # noqa: E402


def emit(rec, out):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def size(cell, args):
    """Peak memory of the training step at growing batches."""
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    from perfbench.lib import weights
    cfg = cell_mod.port_config(cell.config)
    total = torch.cuda.get_device_properties(0).total_memory
    B = 1
    while B <= args.batch:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec = {"cell": cell.name, "batch": B, "total_bytes": total}
        try:
            params = weights.make(cell.run, 1, "cuda")
            state = {"params": params, "opt": adamw.init(params)}
            step = make_train_step(cfg, adamw.AdamWConfig(),
                                   loss_chunk=cell.traffic["loss_chunk"])
            S = cell.traffic["seq_len"]
            times = []
            for _ in range(3):
                seq = torch.randint(0, cell.run["vocab"], (B, S + 1),
                                    device="cuda", dtype=torch.int32)
                t0 = time.perf_counter()
                p, o, m = step(state["params"], state["opt"],
                               {"tokens": seq[:, :-1],
                                "labels": seq[:, 1:].long()})
                float(m["loss"])
                times.append(time.perf_counter() - t0)
            rec.update(peak_bytes=torch.cuda.max_memory_allocated(),
                       step_s=times)
        except torch.cuda.OutOfMemoryError as e:
            rec.update(oom=str(e)[:200])
        emit(rec, args.out)
        state = params = step = None
        gc.collect()
        if "oom" in rec or rec["peak_bytes"] > 0.8 * total:
            break
        B *= 2


def sized(name, out):
    ok = [r["batch"] for r in map(json.loads, open(out))
          if r.get("cell") == name and "peak_bytes" in r and "mode" not in r
          and r["peak_bytes"] <= 0.8 * r["total_bytes"]]
    return max(ok)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--auto-batch", action="store_true",
                    help="the largest batch whose sizing record in --out "
                         "leaves a fifth of the card free")
    args = ap.parse_args(argv)
    cell = cell_mod.resolve(cell_mod.load_benchmark(), args.workload)
    if args.mode == "size":
        args.batch = args.batch or 128
        return size(cell, args)
    if args.batch:
        cell.data["batch"] = args.batch
    elif args.auto_batch:
        cell.data["batch"] = sized(cell.name, args.out)
    fault = args.mode.split(":", 1)[1] if args.mode.startswith("fault:") \
        else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        job = cell.driver.Job(cell, seed, "cuda")
        if fault:
            faults.plant(job, fault)
        spans = job.setup()
        t_setup = time.perf_counter() - t0
        tw = time.perf_counter()
        e2e, attempted, failed = job.window(args.seconds)
        window_wall_s = time.perf_counter() - tw
        peak = torch.cuda.max_memory_allocated()
        job.release()
        t1 = time.perf_counter()
        checks = job.check(job.control() if args.mode == "control"
                           else None)
        emit({"cell": cell.name, "mode": args.mode, "seed": seed,
              "batch": cell.data.get("batch"), "setup_s": t_setup,
              "spans": spans, "window": e2e, "attempted": attempted,
              "failed": failed, "peak_bytes": peak,
              "window_wall_s": window_wall_s,
              "latency_sum_s": sum(r["latency_s"]
                                   for r in getattr(job, "done", [])),
              "check_s": time.perf_counter() - t1,
              "numbers": {n: v for n, v, _ in checks},
              "detail": getattr(job, "detail", None)}, args.out)
        del job
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
