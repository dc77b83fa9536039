"""A cell of ``BENCHMARK.json`` and the files it is found by: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``, which names its driver in ``drivers/``), its own
data (``cells/<cell>.json``: the batch it was sized to, the limits its
outputs are judged by and the readings they were set from), and the
readers of the per-layer metrics that list it (``metrics/<name>.py``)."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return _json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    data: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def run(self) -> Dict[str, Any]:
        """The configuration's numbers as the reference and counts read
        them."""
        return self.config["run"]

    @property
    def driver(self):
        return importlib.import_module(
            f"perfbench.drivers.{self.traffic['driver']}")

    def reader(self, metric: str) -> Callable:
        """``read(ctx)`` of ``metrics/<metric>.py``."""
        path = PERFBENCH / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _lists(entry: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(bench: Dict[str, Any], workload: str,
            base: Path = PERFBENCH) -> Cell:
    """The cell named ``workload`` with its files, and the metrics it
    reports: the end-to-end metrics that list it (or list no cells), the
    per-layer metrics that list it, or that list no cells and move an
    end-to-end metric it reports."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in bench["end_to_end"] if _lists(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(name=workload, chips=w["chips"],
                config=_json(base / "configs" / f"{w['config']}.json"),
                traffic=_json(base / "traffic" / f"{w['traffic']}.json"),
                data=_json(base / "cells" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per_layer)


def port_config(config: Dict[str, Any]):
    """The port's ModelConfig for a configuration file: the port's registry
    entry with every number the file's ``run`` section states."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    run = config["run"]
    fields = dict(n_layers=run["n_layers"], d_model=run["d_model"],
                  vocab=run["vocab"], ssm_type=run["ssm_type"],
                  family=run["family"], ssm_state=run["ssm_state"],
                  ssm_conv=run["ssm_conv"],
                  ssm_expand=run["d_inner"] // run["d_model"],
                  tie_embeddings=run["tie_embeddings"],
                  norm_eps=run["norm_eps"], dtype=run["dtype"])
    cfg = dc.replace(get_config(config["registry"]), **fields)
    if run["ssm_type"] == "mamba1" and max(1, cfg.d_model // 16) != \
            run["dt_rank"]:
        raise SystemExit(f"{config['name']}: the port's dt rank is "
                         f"{max(1, cfg.d_model // 16)}, the file's "
                         f"{run['dt_rank']}")
    return cfg
