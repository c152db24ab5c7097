"""A whole run at a tiny width on the CPU (the harness's look for a chip
skipped): the last line's keys, the metrics BENCHMARK.json gives each
cell, and the command's refusal without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.tiny import SERVE_MIX, TINY, TINY_TRAIN, TRAIN_MIX

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_run(cell, trace=0, seed=2 ** 31 + 17, **config):
    train = harness.Cell(cell).mix["kind"] == "train_loop"
    return harness.execute(
        cell, seed, 2.0, trace, "cpu",
        config_overrides=dict(TINY_TRAIN if train else TINY, **config),
        mix_overrides=TRAIN_MIX if train else SERVE_MIX, root=ROOT)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_result_line(cell):
    r = tiny_run(cell)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert set(r) <= set(KEYS) | {"breakdown", "readings", "checks"}
    assert r["attempted"] > 0 and r["failed"] == 0
    e2e, _ = harness.cell_metrics(SPEC, cell)
    assert set(r["metrics"]) == {m["name"] for m in e2e}
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def test_traced_run_reports_per_layer_host_metrics():
    r = tiny_run("celeba128.train", trace=1)
    assert {"input_wait_ms.train", "dispatch_ms.train",
            "train_mfu"} <= set(r["metrics"])
    # no device on the CPU: the trace's readers find nothing and say so
    assert "idle_share.train" not in r["metrics"]


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                        "celeba128.train", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
