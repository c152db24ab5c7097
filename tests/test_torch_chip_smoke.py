"""chip_smoke.py off the card: it refuses to run without CUDA, and its
kernels line carries the contract's keys. Each phase's CPU rehearsal (what
it drives on the card, where the kernel launches are counted too) is a
file of its own, tests/test_torch_chip_smoke_<phase>.py, so that xdist
spreads them over its workers."""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)


def test_exits_nonzero_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_kernel_entries_cover_the_five_kernels():
    case = {"shape": [64, 128, 128, 128], "dtype": "float32",
            "max_abs_err": 1e-6, "ms": 0.4, "device_ms": 0.4,
            "call_ms": 0.5, "host_ms": 0.1, "plain_ms": 2.0,
            "bound_ms": 0.17, "bound_by": "bytes"}
    entries = [
        chip_smoke.output_stage_entry("output_stage_fwd", "f:1", [case], 3),
        chip_smoke.output_stage_entry(
            "output_stage_bwd", "f:2",
            [dict(case, ddec=True, ms=9.0), dict(case, ddec=False)], 1),
        chip_smoke.adam_entry([dict(case, group="scalar", tensors=1,
                                    elements=1),
                               dict(case, group="ae", tensors=72,
                                    elements=10)], 8)]
    for entry in entries:
        for key in ("name", "route", "source", "replaces", "launches",
                    "max_abs_err", "ms", "device_ms", "call_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms"):
            assert key in entry
        assert entry["ms"] == entry["device_ms"] == 0.4
        assert entry["call_ms"] == 0.5 and entry["route"] == "cuda"
        assert (chip_smoke.ROOT and
                __import__("os").path.isfile(entry["source"]))
    assert set(chip_smoke.kernel_counters()) == {
        "norm_chain_fwd", "norm_chain_bwd", "output_stage_fwd",
        "output_stage_bwd", "adam_update"}
    json.dumps({"kernels": entries})


def test_kernel_entry_has_the_contract_keys():
    cases = [{"shape": list(s), "dtype": dt, "stages_per_decode": k,
              "max_abs_err": 1e-7, "ms": 0.01, "device_ms": 0.01,
              "call_ms": 0.02, "plain_ms": 0.05, "bound_ms": 0.004,
              "bound_by": "bytes"}
             for s, k in chip_smoke.NORM_CHAIN_STAGES
             for dt in ("float32", "bfloat16")]
    # the L2-resident stage is also timed with the cache flushed
    for case in cases:
        if tuple(case["shape"]) == chip_smoke.L2_RESIDENT_STAGE:
            case["device_ms_l2_flushed"] = 0.03
    entry = chip_smoke.norm_chain_entry(cases, launches=28)
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "device_ms", "call_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms"):
        assert key in entry
    assert entry["route"] == "cuda" and entry["library_ms"] is None
    # four stages per decode; the 16x16 one with the L2 cache flushed
    assert entry["ms"] == entry["device_ms"] == pytest.approx(0.06)
    assert entry["device_ms_warm"] == pytest.approx(0.04)
    assert entry["call_ms"] == pytest.approx(0.08)
    assert entry["launches"] == 28
    json.dumps({"kernels": [entry]})


@pytest.mark.parametrize("name, key", [
    ("NVIDIA H100 80GB HBM3", "H100"), ("NVIDIA H100 PCIe", "H100 PCIe"),
    ("NVIDIA H100 NVL", "H100 NVL")])
def test_card_peaks(name, key):
    assert chip_smoke.card_peaks(name)[0] == key


def test_bf16_ulp():
    y = torch.tensor([1.0, 1.5, 2.0, -3.0, 0.0])
    ulp = chip_smoke._bf16_ulp(y)
    np.testing.assert_allclose(ulp[:4].numpy(), [2 ** -7, 2 ** -7, 2 ** -6,
                                                 2 ** -6])
    assert 0 < ulp[4] < 1e-30
