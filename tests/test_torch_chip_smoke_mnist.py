"""chip_smoke.py's mnist_digit trainer phase (5) rehearsed on the CPU at a
tiny data size, with its config and launch count."""

import types

import chip_smoke
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)


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
    assert (cfg["synthetic_n_train"], cfg["synthetic_n_test"]) == (8192,
                                                                    4096)
    # the updates of each group since the step counts of t_before
    trainer = types.SimpleNamespace(state={"opt": {
        "ae": {"t": 468}, "sigma": {"t": 468}, "prior": {"t": 234}}})
    assert chip_smoke.adam_updates(trainer, {"ae": 234, "sigma": 234}) == \
        {"ae": 234, "sigma": 234, "prior": 234}
    assert chip_smoke.adam_updates(trainer, {}) == \
        {"ae": 468, "sigma": 468, "prior": 234}
