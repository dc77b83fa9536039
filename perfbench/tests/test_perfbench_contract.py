"""BENCHMARK.json against the benchmark's contract, and every cell against
the files it is found by."""
import json
import re

import pytest

from perfbench.lib import cell as cell_mod

BENCH = cell_mod.load_benchmark()
ROOT = cell_mod.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_units_and_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] \
                and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for k in entry.get("reduced", []):
        assert NAME.match(k)


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves_to_its_files(workload):
    c = cell_mod.resolve(BENCH, workload)
    assert c.config["name"] == [w for w in BENCH["workloads"]
                                if w["name"] == workload][0]["config"]
    assert c.driver.Job.kind in ("train", "prefill")
    assert c.chips == 1
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(c.reader(m["name"]))
    assert c.data["limits"]


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(config):
    path = ROOT / config["file"]
    assert config["file"].startswith("perfbench/") and path.is_file()
    doc = json.loads(path.read_text())
    assert doc["source"] == config["source"]
    assert doc["reduced"] == config["reduced"]
    for key in config["reduced"]:
        assert key in doc["published"] and doc[key] != doc["published"][key]
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(config["file"]) == 1
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda e: e["name"])
def test_the_port_runs_the_files_numbers(config):
    import dataclasses
    from repro_torch.configs import get_config
    doc = json.loads((ROOT / config["file"]).read_text())
    got = cell_mod.port_config(doc)
    want = dataclasses.replace(get_config(doc["registry"]),
                               n_layers=doc["run"]["n_layers"])
    assert got == want
    assert doc["num_hidden_layers"] == doc["run"]["n_layers"]


def test_end_to_end_metrics():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    for m in e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        for w in m.get("workloads", []):
            assert w in CELLS


def test_per_layer_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            reported = e2e[m["moves"]].get("workloads", CELLS)
            assert w in reported, (m["name"], w)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_command_stays_inside_paths():
    for word in BENCH["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert word.startswith("perfbench/")
