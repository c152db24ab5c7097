"""chip_smoke.py off the card: it refuses to run without CUDA, and its
serving and training phases run end to end on the CPU at a tiny width (the
rehearsal of what it drives on the card, where the kernel launches are
counted too)."""

import json
import types

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


def test_mnist_phase_rehearsal_on_cpu(capsys):
    """Phase 5 at a tiny data size on the CPU: the pretrained mnist_digit
    model through the train CLI's main, 2 epochs then a resume to 3, with
    every check of the phase (the Adam launches counted as none: CPU
    tensors never launch a kernel)."""
    overrides = dict(chip_smoke.MNIST_OVERRIDES, synthetic_n_train=256,
                     synthetic_n_test=128, batch_size=64, n_MC_samples=4)
    res = chip_smoke.drive_mnist("cpu", overrides=overrides,
                                 profile_steps=0, cpu_batch=2)
    first, resumed = res["runs"]
    assert first["epochs"] == (1, 2) and resumed["epochs"] == (3,)
    assert resumed["trainer"].cur_epoch == 3
    assert [t["epoch"] for t in resumed["trainer"].timings] == [3]
    assert not any(r["launches"][k] for r in res["runs"]
                   for k in r["launches"])
    # 4 steps an epoch, the four groups updated in every step
    groups = ("ae", "sigma", "prior", "inner_sigma")
    assert first["group_updates"] == dict.fromkeys(groups, 8)
    assert resumed["group_updates"] == dict.fromkeys(groups, 4)
    assert res["gaps"] == (0.0, 0.0, 0.0, 0.0)
    assert res["artifacts"]["active_mixtures"] >= 1
    # the accurate fit on epoch 2 (accurate_fit) and on the last epoch
    assert [[g["mode"] for g in t["gm"]] for r in res["runs"]
            for t in r["trainer"].timings] == [
        ["fast"], ["fast", "accurate"], ["fast", "accurate"]]
    chip_smoke.log_mnist(res, "cpu")
    out = capsys.readouterr().out
    assert "Full train state restored (epoch 2)." in out
    assert "epoch 3: 4 steps" in out


def test_mnist_phase_config_and_launch_count():
    cfg = chip_smoke.mnist_config()
    assert (cfg["num_hidden_units"], cfg["code_size"],
            cfg["representation_size"], cfg["num_hidden_units_inner_VAE"],
            cfg["n_layers_inner_VAE"], cfg["n_mixtures"],
            cfg["n_MC_samples"], cfg["batch_size"]) == (
        256, 16, 2, 512, 5, 50, 100, 256)
    assert (cfg["synthetic_n_train"], cfg["synthetic_n_test"]) == (60000,
                                                                    10000)
    # the updates of each group since the step counts of t_before
    trainer = types.SimpleNamespace(state={"opt": {
        "ae": {"t": 468}, "sigma": {"t": 468}, "prior": {"t": 234}}})
    assert chip_smoke.adam_updates(trainer, {"ae": 234, "sigma": 234}) == \
        {"ae": 234, "sigma": 234, "prior": 234}
    assert chip_smoke.adam_updates(trainer, {}) == \
        {"ae": 468, "sigma": 468, "prior": 234}


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


def _celeba_groups(tmp_path, cfg):
    """A seeded model's two checkpoint groups at the rehearsal's width."""
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.utils.checkpoint import VAE_KEYS, save_msgpack
    params = make_model(cfg, seed=3).flax_params()
    groups = tmp_path / "groups"
    groups.mkdir()
    save_msgpack(str(groups / "vae-model.msgpack"),
                 {k: params[k] for k in VAE_KEYS})
    save_msgpack(str(groups / "prior-model.msgpack"),
                 {k: params[k] for k in ("prior", "inner_sigma")})
    return str(groups)


def test_celeba_phase_rehearsal_on_cpu(tmp_path, capsys):
    """Phase 6 on the CPU at h=16 with 32 + 16 + 8 synthetic images at
    batch 8: every check of the phase (the launches counted as none: CPU
    tensors never launch a kernel)."""
    overrides = dict(chip_smoke.CELEBA_OVERRIDES, num_hidden_units=16,
                     code_size=16, representation_size=2,
                     num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
                     n_mixtures=3, n_MC_samples=2, batch_size=8,
                     synthetic_n_train=32, synthetic_n_val=16,
                     synthetic_n_test=8)
    groups = _celeba_groups(tmp_path, chip_smoke.celeba_config(overrides))
    res = chip_smoke.drive_celeba("cpu", overrides=overrides, groups=groups,
                                  profile_steps=0, freeze_batches=2,
                                  serve_batch=8)
    first, resumed = res["runs"]
    assert first["epochs"] == (1, 2) and resumed["epochs"] == (3,)
    assert resumed["trainer"].cur_epoch == 3
    assert [t["epoch"] for t in resumed["trainer"].timings] == [3]
    assert [t["epoch"] for t in res["bf16"]["trainer"].timings] == [1]
    assert res["bf16"]["trainer"].model.dtype == torch.bfloat16
    for run in res["runs"] + [res["bf16"]]:
        assert not any(run["launches"].values())
        for t in run["trainer"].timings:
            assert not any(t["launches"].values())
    assert not any(res["serve"]["launches"].values())
    assert res["serve"]["line"]["batches"] == 2
    assert res["serve"]["row_gap"] <= chip_smoke.FROZEN_ROW_MAX_ABS
    assert res["artifacts"]["result_keys"] == sorted(chip_smoke.RESULT_KEYS)
    assert sorted(res["build_seconds"]) == [
        "celebA_test.tfrecords", "celebA_train.tfrecords",
        "celebA_val.tfrecords"]
    assert len(res["reader_s"]) == 4
    chip_smoke.log_celeba(res, "cpu")
    out = capsys.readouterr().out
    assert "Full train state restored (epoch 2)." in out
    assert "celeba float32 run to epoch 3 on cpu" in out
    assert "epoch 3: 4 steps" in out and "freeze_bn over 2 batches" in out


def test_result_keys_are_ladder_tpus(tmp_path):
    from ladder_tpu.utils.metrics import MetricsRecorder
    path = MetricsRecorder().save(
        {"result_dir": str(tmp_path), "exp_name": "celeba"}, [1, 2], 3, 4)
    assert sorted(np.load(path).files) == sorted(chip_smoke.RESULT_KEYS)


def test_celeba_phase_config():
    cfg = chip_smoke.celeba_config()
    assert (cfg["num_hidden_units"], cfg["code_size"],
            cfg["representation_size"], cfg["num_hidden_units_inner_VAE"],
            cfg["n_layers_inner_VAE"], cfg["n_mixtures"],
            cfg["n_MC_samples"], cfg["batch_size"], cfg["dim_input_x"]) == (
        512, 256, 32, 512, 5, 50, 100, 64, 128)
    assert (cfg["synthetic_n_train"], cfg["synthetic_n_val"],
            cfg["synthetic_n_test"], cfg["enable_plots"]) == (1024, 256, 128,
                                                              0)


@pytest.mark.parametrize("mode, overlap, want", [
    # 16 steps, 5 evaluation forwards (the test batch, 4 validation batches)
    (1, False, {"norm_chain_fwd": 16 * 16 + 20, "norm_chain_bwd": 64,
                "output_stage_fwd": 16 * 4 + 5, "output_stage_bwd": 16,
                "adam_update": 64}),
    (1, True, {"norm_chain_fwd": 16 * 16 + 20, "norm_chain_bwd": 64,
               "output_stage_fwd": 16 * 4 + 5, "output_stage_bwd": 16,
               "adam_update": 64}),
    (2, True, {"norm_chain_fwd": 16 * 8 + 20, "norm_chain_bwd": 64,
               "output_stage_fwd": 16 * 2 + 5, "output_stage_bwd": 16,
               "adam_update": 64}),
    (2, False, {"norm_chain_fwd": 16 * 4 + 20, "norm_chain_bwd": 64,
                "output_stage_fwd": 16 + 5, "output_stage_bwd": 16,
                "adam_update": 64})])
def test_expected_epoch_launches(mode, overlap, want):
    cfg = chip_smoke.celeba_config()
    assert chip_smoke.expected_epoch_launches(cfg, mode, 16, 5, overlap,
                                              "cuda") == want
    assert not any(chip_smoke.expected_epoch_launches(
        cfg, mode, 16, 5, overlap, "cpu").values())


def test_copy_overlap():
    """Pinned copies against merged kernel spans: the first copy lies
    under kernels for 8 of its 10 us, the second for none of its 5."""
    events = [("k1", 0.0, 6.0), ("k2", 4.0, 8.0), ("Memcpy HtoD (Pinned -> "
              "Device)", 0.0, 10.0), ("Memcpy HtoD (Pinned -> Device)",
                                      20.0, 25.0), ("k3", 30.0, 31.0),
              ("Memcpy HtoD (Pageable -> Device)", 40.0, 41.0)]
    n, us, share = chip_smoke.copy_overlap(events)
    assert (n, us) == (2, 15.0)
    assert share == pytest.approx(8.0 / 15.0)
    assert chip_smoke.copy_overlap([("k", 0.0, 1.0)]) == (0, 0, None)


def test_a_recorder_that_saw_no_step_fails():
    """A train step built around the recorder leaves it nothing to keep:
    the batch check then fails instead of checking nothing."""
    with chip_smoke._Recorder(2) as rec:
        pass
    with pytest.raises(AssertionError, match="kept 0 batches"):
        rec.kept("run")
    rec.batches = [torch.zeros(1), torch.zeros(1)]
    assert len(rec.kept("run")) == 2
