"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on one host —
the port of ``repro/launch/dryrun.py``.

The reference AOT-compiles each cell's step against ShapeDtypeStruct
stand-ins on 512 placeholder host devices and reads XLA's memory and
cost analyses.  The port traces the real step instead: the production
mesh (``launch.mesh.make_production_mesh``, 16 × 16 or 2 × 16 × 16) over
the ``fake`` process group, in which this process is rank 0; the cell's
abstract inputs (``launch.specs``: DTensors whose local blocks are on the
``meta`` device); and ``make_train_step``, ``make_prefill_step`` or
``make_serve_step`` run on them under ``analysis.costs.CostMode``, which
counts what rank 0 executes: FLOPs, traffic, collectives, and the peak of
the storages it holds.  No CUDA device is touched, so the dry-run runs on
a host without a GPU, or beside a job on the card.

For each cell it reports whether the peak fits an NVIDIA H100 80GB and
what bounds the step (compute, memory or collectives) at the card's
published peaks.  Every figure is predicted, computed on the host: none
is a measurement.  Results append to a JSON file (``--out``, under
``build/``); a cell already in it is skipped, a failing cell is reported
and the sweep goes on, and the exit code is 1 if any cell failed.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    python -m repro_torch.launch.dryrun --all            # every single-pod cell
    python -m repro_torch.launch.dryrun --all --multi-pod both
    python -m repro_torch.launch.dryrun --arch ... --shape ... --multi-pod only
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

RESULTS_DEFAULT = "build/dryrun/dryrun.json"
LABEL = ("predicted for an NVIDIA H100 80GB at its published peaks, "
         "computed on the host; not measured")


def _mesh_label(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def model_flops(cfg, shape) -> int:
    """The reference's useful FLOPs of a step: 6 (train) or 2 (prefill,
    decode) × active parameters × tokens (one a sequence in decode)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = {"train": 6, "prefill": 2, "decode": 2}[shape.kind]
    return mult * cfg.active_param_count() * tokens


def trace_step(cfg, shape, mesh, *, loss_chunk: int = 256):
    """Run ``shape``'s step of ``cfg`` on its abstract inputs under
    ``mesh`` (None: one device) and count it.  Returns ``(costs, state,
    held)``: the step's :class:`~repro_torch.analysis.costs.Costs`, the
    local bytes of its persistent state (parameters, and the optimizer's
    moments (train) or the cache (decode), as the reference counts it),
    and every tensor the step is handed (state and batch)."""
    from repro_torch.analysis import costs as cs
    from repro_torch.launch import specs as sp
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, leaves
    from repro_torch.train.step import (make_prefill_step, make_serve_step,
                                        make_train_step)
    if shape.kind == "train":
        params = sp.abstract_params(cfg, mesh)
        opt = sp.abstract_opt_state(cfg, mesh, params)
        batch = sp.train_inputs(cfg, shape, mesh)
        persistent = leaves(params) + leaves(opt.mu) + leaves(opt.nu) + [
            opt.count]
        held = persistent + list(batch.values())
        step = make_train_step(cfg, AdamWConfig(), loss_chunk=loss_chunk)
        _, costs = cs.count(step, params, opt, batch, mesh=mesh)
    elif shape.kind == "prefill":
        params = sp.abstract_params(cfg, mesh, lm.compute_dtype(cfg))
        batch = sp.train_inputs(cfg, shape, mesh)
        batch.pop("labels")
        persistent = leaves(params)
        held = persistent + list(batch.values())
        _, costs = cs.count(make_prefill_step(cfg), params, batch,
                            mesh=mesh)
    else:
        params = sp.abstract_params(cfg, mesh, lm.compute_dtype(cfg))
        cache, tokens = sp.decode_inputs(cfg, shape, mesh)
        persistent = leaves(params) + leaves(cache)
        held = persistent + [tokens]
        _, costs = cs.count(make_serve_step(cfg), params, cache, tokens,
                            mesh=mesh)
    return costs, cs.state_bytes(persistent), held


def trace_cell(arch: str, shape_name: str, multi_pod: bool,
               kv_chunk: int = 512, loss_chunk: int = 256, *, cfg=None,
               shape=None, mesh_shape=None):
    """Trace one cell on its production mesh; returns the result record.
    ``kv_chunk`` is the reference's argument: the kernels take no chunk.
    ``cfg``, ``shape`` and ``mesh_shape`` (with axes ("data", "model"),
    or ("pod", "data", "model") for three dims) stand in for the
    registry's config, the named shape and the production mesh: the
    tests' small cells."""
    from repro_torch.analysis import costs as cs
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import (MULTI_POD, SINGLE_POD, fake_world,
                                         make_production_mesh)
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if mesh_shape is None:
        mesh_shape = (MULTI_POD if multi_pod else SINGLE_POD)[0]
    names = ("data", "model") if len(mesh_shape) == 2 else (
        "pod", "data", "model")
    n_chips = math.prod(mesh_shape)
    with fake_world(n_chips):
        if mesh_shape in (SINGLE_POD[0], MULTI_POD[0]):
            mesh = make_production_mesh(multi_pod=len(mesh_shape) == 3)
        else:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
        # long-context decode with a batch the data axes do not divide:
        # the cache sequence-sharded over "data", partial softmaxes merged
        sp_axis = None
        if shape.kind == "decode" and cfg.has_attention:
            daxes = sh.data_axes(mesh)
            if shape.global_batch % sh.axis_size(mesh, daxes) != 0:
                sp_axis = "data"
        sh.set_mesh(mesh, sp_decode_axis=sp_axis)
        t0 = time.time()
        try:
            costs, state, held = trace_step(cfg, shape, mesh,
                                            loss_chunk=loss_chunk)
        finally:
            sh.set_mesh(None)
        trace_s = time.time() - t0
        terms = cs.roofline_terms(costs, mesh)
        peak = (cs.state_bytes(held, cs.ALLOC_ROUND) + costs.temp_peak_bytes
                + costs.cublas_bytes)
    total = model_flops(cfg, shape)
    per_chip = total / n_chips
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": list(mesh_shape),
        "axes": list(names),
        "chips": int(n_chips),
        "trace_s": round(trace_s, 2),
        "predicted": LABEL,
        "memory": {
            "peak_bytes_per_device": int(peak),
            "state_bytes_per_device": int(state),
            "step_peak_bytes_per_device": int(costs.temp_peak_bytes),
            "workspace_bytes_per_device": int(costs.workspace_bytes),
            "cublas_bytes_per_device": int(costs.cublas_bytes),
            "capacity_bytes": cs.HBM_BYTES,
        },
        "fits": peak <= cs.HBM_BYTES,
        "per_chip": {
            "flops": costs.flops,
            "flops_by_dtype": costs.flops_by_dtype,
            "traffic_bytes": costs.traffic_bytes,
            "collective_bytes": costs.collective_bytes,
            "by_collective": costs.by_collective,
            "by_axis": costs.by_axis,
            "kernel_calls": costs.kernel_calls,
            "ops": costs.ops,
        },
        "roofline": terms,
        "model_flops_total": total,
        "model_flops_per_chip": per_chip,
        "useful_flop_ratio": per_chip / costs.flops if costs.flops else None,
        "hbm_state_bytes_per_device": int(state),
    }


def run_cells(cell_list, out_path: str, kv_chunk: int, loss_chunk: int,
              trace=trace_cell):
    """Trace each (arch, shape, multi_pod) of ``cell_list`` not yet in
    ``out_path``, appending its record there; returns the failures as
    (label, error) pairs."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    results = []
    if os.path.exists(out_path):
        with open(out_path) as fh:
            results = json.load(fh)
    done = {(r["arch"], r["shape"], tuple(r["mesh"])) for r in results}
    failures = []
    for arch, shape_name, multi_pod in cell_list:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
        label = f"{arch} × {shape_name} × {_mesh_label(multi_pod)}"
        if (arch, shape_name, mesh_shape) in done:
            print(f"skip {label} (done)")
            continue
        print(f"=== {label}", flush=True)
        try:
            rec = trace(arch, shape_name, multi_pod, kv_chunk=kv_chunk,
                        loss_chunk=loss_chunk)
            r, m = rec["roofline"], rec["memory"]
            print(f"    ok  trace {rec['trace_s']}s  peak "
                  f"{m['peak_bytes_per_device'] / 1e9:.3f} GB "
                  f"({'fits' if rec['fits'] else 'DOES NOT FIT'})  "
                  f"dominant={r['dominant']} compute={r['compute_s']:.4f}s "
                  f"memory={r['memory_s']:.4f}s "
                  f"collective={r['collective_s']:.4f}s", flush=True)
            results.append(rec)
            with open(out_path, "w") as fh:
                json.dump(results, fh, indent=1)
        except Exception as e:  # noqa: BLE001 — a sweep reports, not dies
            print(f"    FAIL {e}", flush=True)
            traceback.print_exc()
            failures.append((label, str(e)))
    return failures


def main(argv=None) -> int:
    from repro_torch.configs import cells
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", choices=["no", "only", "both"],
                    default="no")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DEFAULT)
    ap.add_argument("--kv-chunk", type=int, default=512,
                    help="the plain attention's kv chunk (the reference's); "
                    "sizes nothing on the kernel path the dry-run traces")
    ap.add_argument("--loss-chunk", type=int, default=256)
    args = ap.parse_args(argv)

    if args.all:
        todo = []
        for arch, shape_name in cells():
            if args.multi_pod in ("no", "both"):
                todo.append((arch, shape_name, False))
            if args.multi_pod in ("only", "both"):
                todo.append((arch, shape_name, True))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required without --all")
        pods = {"no": [False], "only": [True], "both": [False, True]}
        todo = [(args.arch, args.shape, mp) for mp in pods[args.multi_pod]]

    failures = run_cells(todo, args.out, args.kv_chunk, args.loss_chunk)
    if failures:
        print(f"\n{len(failures)} cell(s) FAILED:")
        for label, err in failures:
            print(f"  {label}: {err}")
        return 1
    print(f"\nall cells traced OK ({LABEL}); results in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
