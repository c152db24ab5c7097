"""The yardstick's arithmetic against the numbers the repository measured
with its own tools (PERF.md: conv_breakdown's GF column, the five
kernels' byte bounds)."""

import json
from pathlib import Path

import pytest

from portbench import yardstick
from portbench.reference.ladder_celeba import group_names, param_spec

ROOT = Path(__file__).resolve().parents[2]
CELEBA = json.loads((ROOT / "portbench/configs/celeba128.json").read_text())[
    "config"]

# conv_breakdown's GF column at batch 64, h=512 (PERF.md)
GF = {"enc1": 1.81, "enc2": 19.33, "enc3": 9.66, "enc4": 4.83,
      "enc5": 2.42, "enc6 valid": 1.21, "dec 2x2 a": 1.21,
      "dec 2x2 b": 1.21, "dec 8x8": 19.33, "dec 16x16": 38.65,
      "dec 32x32": 77.31, "dec 64x64": 154.62, "dec 128x128": 309.24,
      "dec 1x1 out": 0.81}


def test_conv_flops_reproduce_conv_breakdown():
    enc, dec = yardstick.conv_layers(CELEBA)
    got = {l[0]: yardstick.conv_flops(64, l) / 1e9 for l in enc + dec}
    for name, gf in GF.items():
        assert got[name] == pytest.approx(gf, abs=0.006), name
    assert sum(got[n] for n in GF) == pytest.approx(641.6, abs=0.1)


def test_step_flops():
    assert yardstick.train_step_flops(CELEBA, 64, 1) / 1e12 == \
        pytest.approx(2.65, abs=0.02)
    assert yardstick.train_step_flops(CELEBA, 512, 2) / 1e12 == \
        pytest.approx(15.4, abs=0.1)
    f = yardstick.forward_flops(CELEBA, 64)
    assert yardstick.serve_row_flops(CELEBA, "reconstruct") * 64 == \
        pytest.approx(f["enc"] + f["dec"])


def test_kernel_bounds_reproduce_perf_md():
    b = yardstick.kernel_bounds(CELEBA, 64, "float32")
    ms = {k: 1e3 * yardstick.bound_seconds(*v, "float32")
          for k, v in b.items()}
    assert round(ms["norm_chain_fwd"], 3) == 0.091
    assert round(ms["norm_chain_bwd"], 3) == 0.137
    assert round(ms["output_stage_fwd"], 3) == 0.168
    assert round(ms["output_stage_bwd"], 3) == 0.328
    spec = dict(param_spec(CELEBA))
    n = sum(int(__import__("math").prod(spec[k]))
            for k in group_names(param_spec(CELEBA))["ae"])
    assert round(1e3 * yardstick.adam_bytes(n) / yardstick.PEAK_BYTES_S,
                 3) == 0.158


def test_percentile_counts_a_missing_answer_as_slowest():
    assert yardstick.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0
    assert yardstick.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == \
        pytest.approx(4.8)
    assert yardstick.percentile([1.0] * 19 + [float("inf")], 100) == \
        float("inf")


def test_summarise_reads_window_busy_and_kernels(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": yardstick.WINDOW_MARK,
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 100,
         "dur": 300},
        {"ph": "X", "cat": "kernel", "name": "norm_chain_fwd_ring",
         "ts": 100, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 250, "dur": 150},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 700,
         "dur": 100},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = yardstick.summarise(yardstick.read_trace(str(path)))
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(400e-6)
    assert s["idle_share"] == pytest.approx(0.6)
    assert s["kernels"]["norm_chain_fwd"] == (1, pytest.approx(200e-6))
    assert s["kernels"]["adam_update"] == (0, 0.0)
    assert len(s["breakdown"]["device_ops"]) == 3
