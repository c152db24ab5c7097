"""chip_smoke.py off the card: it refuses to run without CUDA, and its
serving and training phases run end to end on the CPU at a tiny width (the
rehearsal of what it drives on the card, where the kernel launches are
counted too)."""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_serving import tiny_celeba


def test_exits_nonzero_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_serving_phase_rehearsal_on_cpu(tmp_path):
    cfg = tiny_celeba(tmp_path)
    run = chip_smoke.drive_serving(cfg, "cpu")
    assert run["launches"] == 0  # CPU tensors never launch the kernel
    assert [name for name, _ in run["calls"]] == [
        "reconstruct[64]", "reconstruct[3]", "encode", "represent", "decode",
        "decode_representation", "generate", "t_log_density",
        "reconstruct[64] bf16", "HTTP POST /reconstruct[3]"]
    assert run["gpu_cpu_max_abs"] == 0.0
    assert run["bf16_mean_abs"] <= chip_smoke.BF16_BAND_MEAN_ABS
    lat = chip_smoke.path_latencies(run["engine"], run["x"][:4], repeats=1)
    assert set(lat) == {"encode", "reconstruct", "represent", "decode",
                        "decode_representation", "generate"}


def test_training_phase_rehearsal_on_cpu(tmp_path):
    import jax
    from ladder_tpu.models.builder import make_model as jmake
    from ladder_tpu_torch.ops.distributions import gmm_cholesky

    cfg = tiny_celeba(tmp_path)
    params = jax.tree.map(np.asarray, jmake(cfg).init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    gm = dict(weights=torch.full((4,), 0.25),
              means=torch.tensor(rng.standard_normal((4, 2)), dtype=torch.float32),
              chols=gmm_cholesky(torch.stack([torch.eye(2) * 0.5] * 4)))
    images = rng.random((4, 128, 128, 3)).astype(np.float32)
    chip_smoke.reset_counters()
    train = chip_smoke.drive_training(cfg, params, gm, images, "cpu",
                                      steps=2, cpu_batch=2)
    assert set(train) == {1, 2}
    for mode, res in train.items():
        assert len(res["step_ms"]) == 2 and len(res["loss_ae"]) == 2
        assert res["state"]["step"] == 2
        # CPU tensors never launch a kernel
        assert not any(res["launches"].values())
        assert res["metric_gap"] == 0.0 and res["param_gap_max_lr"] == 0.0
    assert not any(chip_smoke.read_counters().values())


@pytest.mark.parametrize("mode, want", [
    (1, {"norm_chain_fwd": 16, "norm_chain_bwd": 4, "output_stage_fwd": 4,
         "output_stage_bwd": 1, "adam_update": 4}),
    (2, {"norm_chain_fwd": 4, "norm_chain_bwd": 4, "output_stage_fwd": 1,
         "output_stage_bwd": 1, "adam_update": 4})])
def test_expected_step_launches(tmp_path, mode, want):
    cfg = tiny_celeba(tmp_path)
    assert chip_smoke.expected_step_launches(cfg, mode, "cuda") == want
    assert not any(chip_smoke.expected_step_launches(cfg, mode,
                                                     "cpu").values())


def test_kernel_entries_cover_the_five_kernels():
    case = {"shape": [64, 128, 128, 128], "dtype": "float32",
            "max_abs_err": 1e-6, "ms": 0.4, "plain_ms": 2.0,
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
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            assert key in entry
        assert entry["ms"] == 0.4 and entry["route"] == "cuda"
        assert (chip_smoke.ROOT and
                __import__("os").path.isfile(entry["source"]))
    assert set(chip_smoke.kernel_counters()) == {
        "norm_chain_fwd", "norm_chain_bwd", "output_stage_fwd",
        "output_stage_bwd", "adam_update"}
    json.dumps({"kernels": entries})


def test_kernel_entry_has_the_contract_keys():
    cases = [{"shape": list(s), "dtype": dt, "stages_per_decode": k,
              "max_abs_err": 1e-7, "ms": 0.01, "plain_ms": 0.05,
              "bound_ms": 0.004, "bound_by": "bytes"}
             for s, k in chip_smoke.NORM_CHAIN_STAGES
             for dt in ("float32", "bfloat16")]
    entry = chip_smoke.norm_chain_entry(cases, launches=28)
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in entry
    assert entry["route"] == "cuda" and entry["library_ms"] is None
    assert entry["ms"] == pytest.approx(0.04)  # four stages per decode
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
