"""Every data file parses and names what exists; BENCHMARK.json and the
files under portbench/ agree."""

import json
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = sorted(p.stem for p in (PB / "workloads").glob("*.json"))


@pytest.mark.parametrize("cell", CELLS)
def test_workload_names_existing_files(cell):
    c = harness.Cell(cell)
    assert c.chips in (1, 4)
    assert c.config["exp_name"] == "celeba"
    assert hasattr(c.kind, "run")
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert len(c.workload["why"]) <= 200


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (PB / "configs").glob("*.json")))
def test_config_file_states_its_cut(name):
    f = json.loads((PB / "configs" / f"{name}.json").read_text())
    assert f["source"].startswith("https://")
    assert isinstance(f["reduced"], list) and f["config"]
    assert (ROOT / f["reference"]).is_file()


def test_benchmark_json_matches_the_files():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for cfg in SPEC["configs"]:
        f = json.loads((ROOT / cfg["file"]).read_text())
        assert f["reduced"] == cfg["reduced"]
        assert f["source"] == cfg["source"]
    for w in SPEC["workloads"]:
        c = harness.Cell(w["name"])
        assert (c.workload["config"], c.workload["traffic"], c.chips) == (
            w["config"], w["traffic"], w["chips"])
        e2e, layer = harness.cell_metrics(SPEC, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer
    for m in SPEC["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
