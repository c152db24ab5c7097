"""The train CLIs of both packages on copies of the repo's own configs with
no enable_plots key (so plots are on): codes/mnist_digit_config.json with
the tiny sizes of .claude/skills/verify/SKILL.md, and
demo/celeba_config.json on its synthetic TFRecords with the sizes of
tests/test_torch_celeba_trainer.py. The port's python -m
ladder_tpu_torch.train writes the PDF set that ladder_tpu's train.py
writes on the same copy, CelebA's mid-epoch reconstructions included."""

import importlib
import json
import os
from pathlib import Path

import pytest

from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)
from tests.test_torch_trainer import _run_cli

ROOT = Path(__file__).resolve().parents[1]
# .claude/skills/verify/SKILL.md's tiny mnist config, without enable_plots
TINY_MNIST = {"num_epochs": 4, "sg_pretraining": 1, "accurate_fit": 2,
              "batch_size": 64, "n_mixtures": 4, "n_MC_samples": 4,
              "num_hidden_units": 64, "num_hidden_units_inner_VAE": 16,
              "n_layers_inner_VAE": 2, "synthetic_data": 1,
              "synthetic_n_train": 512, "synthetic_n_test": 128}
# tests/test_torch_celeba_trainer.py:TINY's sizes, without enable_plots
TINY_CELEBA = dict(num_hidden_units=16, code_size=16, batch_size=8,
                   num_epochs=1, sg_pretraining=1, accurate_fit=2,
                   n_MC_samples=2, n_mixtures=3, num_iter_to_plot=2,
                   synthetic_n_train=32, synthetic_n_val=16,
                   synthetic_n_test=8, num_hidden_units_inner_VAE=8,
                   n_layers_inner_VAE=2, load_dir="default", load_model=1)


def _pdfs(d):
    return sorted(p for p in os.listdir(d) if p.endswith(".pdf"))


def _train_py(root, cfg_path):
    """ladder_tpu's train.py main in ``root`` -> its result directory."""
    old = os.getcwd()
    os.chdir(root)
    try:
        importlib.import_module("train").main(["--config", str(cfg_path)])
    finally:
        os.chdir(old)
    [result] = [p for p in root.rglob("result") if p.is_dir()]
    return result


@pytest.mark.parametrize("source, overrides", [
    ("codes/mnist_digit_config.json", TINY_MNIST),
    ("demo/celeba_config.json", TINY_CELEBA)], ids=["mnist_digit", "celeba"])
def test_train_clis_plot_the_repos_configs_alike(tmp_path, source,
                                                 overrides):
    """A copy of the repo's config with no enable_plots key (so plots are
    on) trains through both train CLIs and writes the same PDFs."""
    cfg = json.loads((ROOT / source).read_text())
    assert "enable_plots" not in cfg
    cfg.update(overrides)
    if cfg["exp_name"] == "celeba":
        cfg["data_path"] = str(tmp_path / "data") + "/"
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _pdfs(_train_py(tmp_path / "jax", cfg_path))
    trainer = _run_cli(tmp_path / "port", ["--config", str(cfg_path),
                                           "--device", "cpu"])
    assert _pdfs(trainer.config["result_dir"]) == want
    assert want and all(name.endswith(".pdf") for name in want)
    if cfg["exp_name"] == "celeba":
        # the mid-epoch reconstructions at idx_check_point [0, 2]
        assert {"test_reconstructed_1_0_0.pdf",
                "test_reconstructed_1_2_0.pdf"} <= set(want)
