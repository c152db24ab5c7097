"""chip_smoke.py's train-step phase (4) and CelebA trainer phase (6)
rehearsed on the CPU at a tiny width, with their configs and launch counts."""

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)
from tests.test_torch_serving import tiny_celeba
from tests.torch_chip_smoke_helpers import _celeba_groups


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
