"""chip_smoke.py's interpolation and other-trainer phase (7) rehearsed on
the CPU at a tiny width, with its configs and launch counts."""

import chip_smoke
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)
from tests.torch_chip_smoke_helpers import SMALL_CELEBA, _demo_cfg, _groups


# phase 7 on the CPU: the pretrained mnist_digit model on 512 + 256
# synthetic images; CelebA at h=16 from seeded groups; 100 SLP iterations
# between validation images 0 and 3, whose straight line crosses low
# density in both models (a seeded mnist model's t collapse to within
# 0.01 of each other, and where the line lies in the bulk of the density,
# Adam's lr-sized steps cost more step variance than the likelihood can
# gain: the phase's check that the path beats the line would not hold for
# any implementation)
SMALL_MNIST = dict(num_hidden_units=64, code_size=8,
                   num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
                   n_mixtures=4, n_MC_samples=4, batch_size=64,
                   synthetic_data=1, synthetic_n_train=256,
                   synthetic_n_test=128)
PRETRAINED_MNIST = dict(chip_smoke.INTERP_MNIST_OVERRIDES,
                        synthetic_n_train=512, synthetic_n_test=256)
SMALL_ARGV = ("--idx-start", "0", "--idx-end", "3", "--n-step", "8",
              "--n-iter", "100")


def test_interp_phase_rehearsal_on_cpu(tmp_path, capsys):
    """Phase 7's interpolations on the CPU: every check of the phase (the
    CPU replay equal to the run itself, the launches counted as none)."""
    celeba = _groups(tmp_path, _demo_cfg(chip_smoke.CONFIG, SMALL_CELEBA),
                     "celeba")
    res = chip_smoke.drive_interp(
        "cpu", mnist_overrides=PRETRAINED_MNIST,
        celeba_overrides=SMALL_CELEBA, celeba_groups=celeba,
        argv=SMALL_ARGV,
        data_dir=str(tmp_path / "data"), profile_iters=0)
    for run in (res["mnist"], res["celeba"]):
        assert not any(run["launches"].values())
        assert run["fit"]["mode"] == "accurate"
        assert run["linear"]["first"] == dict.fromkeys(
            ("obj", "path_length", "neg_ll", "step_var"), 0.0)
        assert run["linear"]["final_points"] == 0.0
        assert run["linear"]["parts_at"] is None
        assert run["final"]["neg_ll"][1] < run["final"]["neg_ll"][0]
    assert res["mnist"]["fit"]["samples"] == 512
    assert res["celeba"]["fit"]["samples"] == 32
    assert res["mnist"]["random"]["final_points"] == 0.0
    assert "random" not in res["celeba"]
    assert sorted(p.name for p in (tmp_path / "data" / "data").iterdir()) \
        == ["celebA_test.tfrecords", "celebA_train.tfrecords",
            "celebA_val.tfrecords"]
    out = capsys.readouterr().out
    assert out.count("Final loss: ") == 2


def test_other_trainers_rehearsal_on_cpu(tmp_path, capsys):
    """Phase 7's fashion and GMM runs on the CPU at h=64: every check of
    the phase, then its log."""
    small = dict(SMALL_MNIST, code_size=8, n_mixtures=4)
    fashion = dict(chip_smoke.FASHION_OVERRIDES, **small)
    groups = _groups(tmp_path, _demo_cfg(chip_smoke.FASHION_CONFIG,
                                         fashion), "fashion")
    gmm = dict(chip_smoke.GMM_OVERRIDES, **small)
    others = chip_smoke.drive_other_trainers(
        "cpu", fashion_overrides=fashion, gmm_overrides=gmm,
        fashion_groups=str(tmp_path / "fashion" / "mnist_fashion"))
    del groups
    steps = 256 // 64
    assert others["fashion"]["group_updates"]["ae"] == steps
    assert others["gmm"]["group_updates"] == {"ae": 2 * steps,
                                              "sigma": 2 * steps}
    assert others["gmm"]["gm_files"] == [
        "K_active", "K_full", "m_active", "m_full", "w_active", "w_full"]
    assert others["gmm"]["gm_shapes"]["K_full"] == (4, 8, 8)
    assert all(not any(t["launches"].values())
               for key in ("fashion", "gmm")
               for t in others[key]["trainer"].timings)
    chip_smoke.log_interp(
        {"mnist": _fake_interp("mnist_digit"),
         "celeba": _fake_interp("CelebA-128")}, others, "cpu")
    out = capsys.readouterr().out
    assert "mnist_fashion ours run on cpu" in out
    assert "GMM run: GM_prior_info.npz" in out


def _fake_interp(label):
    fit = {"samples": 8, "n_iter": 3, "converged": True, "seconds": 0.1}
    final = {k: (1.0, 0.5) for k in ("obj", "path_length", "step_var",
                                     "neg_ll")}
    return {"label": label, "seconds": 1.0, "fit": fit, "slp_seconds": 0.5,
            "n_iter": 500, "launches": {}, "final": final,
            "launches_per_iter": 900.0}


def test_interp_phase_configs_and_launch_count():
    mnist = _demo_cfg(chip_smoke.MNIST_CONFIG,
                      chip_smoke.INTERP_MNIST_OVERRIDES)
    assert (mnist["num_hidden_units"], mnist["code_size"],
            mnist["representation_size"],
            mnist["num_hidden_units_inner_VAE"], mnist["n_layers_inner_VAE"],
            mnist["n_mixtures"], mnist["batch_size"],
            mnist["synthetic_n_train"], mnist["synthetic_n_test"]) == (
        256, 16, 2, 512, 5, 50, 256, 8192, 2048)
    celeba = _demo_cfg(chip_smoke.CONFIG, chip_smoke.INTERP_CELEBA_OVERRIDES)
    assert (celeba["num_hidden_units"], celeba["code_size"],
            celeba["representation_size"], celeba["n_mixtures"],
            celeba["batch_size"]) == (512, 256, 32, 50, 64)
    assert chip_smoke.INTERP_ARGS[-1] == "250"
    # two embeddings (a decode of z and of t each) and two strips, four
    # norm-chain stages a decode; mnist decoders launch none
    assert chip_smoke.expected_interp_launches(celeba, 2, 2, "cuda") == {
        "norm_chain_fwd": 24, "norm_chain_bwd": 0, "output_stage_fwd": 0,
        "output_stage_bwd": 0, "adam_update": 0}
    assert not any(chip_smoke.expected_interp_launches(
        dict(celeba, prior="GMM"), 2, 2, "cpu").values())
    assert chip_smoke.expected_interp_launches(
        dict(celeba, prior="GMM"), 2, 2, "cuda")["norm_chain_fwd"] == 16
    assert not any(chip_smoke.expected_interp_launches(
        mnist, 2, 2, "cuda").values())
    gmm = _demo_cfg(chip_smoke.MNIST_CONFIG, chip_smoke.GMM_OVERRIDES)
    assert (gmm["prior"], gmm["num_epochs"], gmm["sg_pretraining"],
            gmm["load_model"], gmm["synthetic_n_train"]) == (
        "GMM", 2, 1, 0, 8192)
