"""chip_smoke.py's utilities phase (8) and quality phase (11) rehearsed on
the CPU at a tiny width, with their configs and launch counts."""

import json

import numpy as np

import chip_smoke
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)
from tests.torch_chip_smoke_helpers import SMALL_CELEBA, _demo_cfg, _groups


def test_utils_phase_rehearsal_on_cpu(tmp_path, capsys):
    """Phase 8 on the CPU: prior samples of the pretrained mnist_digit
    model's five priors and of CelebA at h=16 from seeded groups, the
    exports of both engines at batch 4, an async-checkpoint epoch of the
    pretrained mnist_digit model on 256 images, the FID over 16 images
    each, and the refused plots: every check of the phase (the CPU
    replays equal to the runs themselves, the launches counted as none),
    then its log."""
    from ladder_tpu_torch.utils.checkpoint import save_gm_prior_info

    small = dict(SMALL_CELEBA, **chip_smoke.UTILS_CELEBA_OVERRIDES)
    celeba_root = _groups(tmp_path, _demo_cfg(chip_smoke.CONFIG, small),
                          "celeba")
    groups = f"{celeba_root}/celeba"
    rng = np.random.default_rng(0)
    save_gm_prior_info(groups, np.full(3, 1 / 3), rng.standard_normal((3, 2)),
                       np.stack([np.eye(2) * 0.5] * 3))
    celeba_cfg = chip_smoke._demo_config(chip_smoke.CONFIG, small,
                                         celeba_root, str(tmp_path / "c"))
    mnist_cfg = chip_smoke._demo_config(
        chip_smoke.MNIST_CONFIG, chip_smoke.UTILS_MNIST_OVERRIDES,
        str(chip_smoke.ROOT) + "/pretrained_models", str(tmp_path / "m"))
    res = chip_smoke.drive_utils(
        "cpu", sampling=dict(celeba_overrides=small, celeba_groups=groups),
        export_cfgs=(celeba_cfg, mnist_cfg), fid_cfg=celeba_cfg,
        fid_images=16, serve_batch=4, repeats=1,
        async_overrides=dict(chip_smoke.ASYNC_OVERRIDES,
                             synthetic_n_train=256, synthetic_n_test=128,
                             n_MC_samples=4, batch_size=64))
    assert not any(res["launches"].values())  # CPU tensors launch nothing
    assert [r["label"] for r in res["sampling"]] == [
        "mnist_digit ours", "mnist_digit GMM", "mnist_digit standard_gaussian",
        "mnist_digit hierarchical", "mnist_digit vampPrior", "CelebA-128 ours"]
    assert all(r["cpu_max_abs"] == 0.0 for r in res["sampling"])
    assert res["sampling"][-1]["shape"] == (100, 128, 128, 3)
    assert res["sampling"][-1]["name"] == chip_smoke.UTILS_CELEBA_NAME
    celeba, mnist = res["export"]
    assert sorted(celeba["paths"]) == ["decode", "decode_representation",
                                       "encode", "reconstruct", "represent"]
    assert sorted(mnist["paths"]) == sorted(celeba["paths"])
    assert all(row["max_abs"] == 0.0 and row["launches"] == 0
               for e in res["export"] for row in e["paths"].values())
    assert res["async"]["run"]["group_updates"]["ae"] == 4
    assert set(res["async"]["bytes"]) == set(chip_smoke.CHECKPOINT_FILES)
    assert res["fid"]["rel"] == 0.0 and res["fid"]["card"] > 0
    assert "matplotlib" in res["plots"]["message"]
    chip_smoke.log_utils(res, "cpu")
    out = capsys.readouterr().out
    assert "async checkpoints on cpu" in out
    assert "export CelebA-128 ours on cpu" in out


def test_utils_phase_configs():
    cfg = _demo_cfg(chip_smoke.MNIST_CONFIG,
                    chip_smoke.UTILS_MNIST_OVERRIDES)
    # epoch 20 of sg_pretraining 10 and accurate_fit 10: 'ours' samples its
    # accurate fit; num_epochs 0: so does 'GMM'
    assert (cfg["sg_pretraining"], cfg["accurate_fit"],
            cfg["num_epochs"]) == (10, 10, 0)
    celeba = _demo_cfg(chip_smoke.CONFIG, chip_smoke.UTILS_CELEBA_OVERRIDES)
    assert (celeba["num_hidden_units"], celeba["code_size"],
            celeba["sg_pretraining"], celeba["accurate_fit"]) == (
        512, 256, 10, 3)
    assert chip_smoke.UTILS_CELEBA_EPOCH % 3 == 0
    assert chip_smoke.ASYNC_OVERRIDES["async_checkpoint"] == 1


def test_quality_phase_rehearsal_on_cpu(tmp_path, capsys):
    """Phase 11 on the CPU: the mnist_digit record at h=64 (the mnist
    decoder's last stage has h // 64 channels; 3 epochs of 256 images, the
    prior's groups from epoch 2, a fit after epoch 3), eval_fid on its
    files and the CelebA record at h=16 (16 images at batch 8), in this
    process; every check of the phase (the launches counted as none: CPU
    tensors never launch a kernel)."""
    small = dict(num_hidden_units=16, n_mixtures=3, n_MC_samples=2,
                 num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2)
    digit = ("--config", "codes/mnist_digit_config.json", "--epochs", "3",
             "--n-train", "256", "--n-test", "128", "--fid-samples", "64",
             "--override", json.dumps(dict(small, sg_pretraining=2,
                                           accurate_fit=1, batch_size=64,
                                           num_hidden_units=64)))
    celeba = ("--config", "codes/celeba_config.json", "--epochs", "1",
              "--n-train", "16", "--n-test", "8", "--fid-samples", "8")
    res = chip_smoke.drive_quality(
        "cpu", digit_args=digit, celeba_args=celeba,
        celeba_overrides=dict(chip_smoke.QUALITY_CELEBA_OVERRIDES,
                              code_size=16, batch_size=8,
                              synthetic_n_val=8, **small))
    for key, epochs in (("digit", 3), ("celeba", 1)):
        rec = res[key]["record"]
        assert rec["recipe"]["num_epochs"] == epochs
        assert rec["active_mixtures"] >= 1
        assert abs(rec["encoder_fid_self_floor"]) < chip_smoke.QUALITY_SELF_FLOOR
        assert not any(res[key]["launches"].values())
    # epoch 1 pretrains (the ae and sigma groups); the prior's groups
    # train from the last pretraining epoch on, as in (a): 4 steps an epoch
    assert [t["group_updates"] for t in res["digit"]["timings"]] == [
        {"ae": 4, "sigma": 4, "prior": 0, "inner_sigma": 0}] + [
        {"ae": 4, "sigma": 4, "prior": 4, "inner_sigma": 4}] * 2
    assert res["celeba"]["record"]["recipe"]["exp_name"] == "celeba"
    assert res["celeba"]["record"]["fid_samples"] == 8
    assert res["digit"]["eval_fid"]["rel"] <= chip_smoke.QUALITY_EVAL_FID_RTOL
    assert not any(res["launches"].values())
    chip_smoke.log_quality(res, "cpu")
    out = capsys.readouterr().out
    assert "mnist_digit record on cpu" in out and "celeba record on cpu" in out
    assert "eval_fid --network encoder" in out


def test_quality_phase_configs_and_generation_launches():
    """Phase 11 at the published widths: only data and epochs cut, (a)
    ending one epoch after sg_pretraining; a CelebA decoding call is four
    norm-chain launches."""
    from ladder_tpu_torch.utils.config import process_config
    args = dict(zip(chip_smoke.QUALITY_DIGIT_ARGS[::2],
                    chip_smoke.QUALITY_DIGIT_ARGS[1::2]))
    digit = process_config(f"{chip_smoke.ROOT}/{args['--config']}")
    assert int(args["--epochs"]) == digit["sg_pretraining"] + 1
    assert (digit["num_hidden_units"], digit["batch_size"],
            digit["n_mixtures"], digit["n_MC_samples"]) == (256, 256, 50, 100)
    args = dict(zip(chip_smoke.QUALITY_CELEBA_ARGS[::2],
                    chip_smoke.QUALITY_CELEBA_ARGS[1::2]))
    celeba = process_config(f"{chip_smoke.ROOT}/{args['--config']}")
    assert (celeba["num_hidden_units"], celeba["code_size"],
            celeba["batch_size"]) == (512, 256, 64)
    assert set(chip_smoke.QUALITY_CELEBA_OVERRIDES) == {
        "sg_pretraining", "accurate_fit", "synthetic_n_val"}
    assert chip_smoke.expected_generation_launches(
        celeba, 65, 64, "cuda") == dict(
        dict.fromkeys(chip_smoke.kernel_counters(), 0), norm_chain_fwd=8)
    assert not any(chip_smoke.expected_generation_launches(
        digit, 512, 64, "cuda").values())
    assert not any(chip_smoke.expected_generation_launches(
        celeba, 64, 64, "cpu").values())
