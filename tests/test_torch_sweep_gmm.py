"""python -m ladder_tpu_torch.sweep_gmm against scripts/sweep_gmm.py on
tests/test_scripts.py's tiny recipe at two arms: the same -sweepK{n}
directories, the same table and JSON schema, and each arm's
active_mixtures the port trainer's own fast-fit count. The JAX script
runs with its trainer stubbed (its directories and lines are what is
compared; the trainers' numerics are held by tests/test_torch_trainer.py,
and two RNGs never give equal losses)."""

import contextlib
import importlib.util
import io
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ladder_tpu_torch import sweep_gmm as port
from tests.conftest import make_config
from tests.test_torch_losses import few_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARMS = ("3", "4")


def _config(tmp_path):
    cfg = make_config(prior="ours", num_epochs=1, sg_pretraining=0,
                      n_MC_samples=2, num_hidden_units=64,
                      num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
                      synthetic_n_train=128, synthetic_n_test=128,
                      batch_size=64, enable_plots=0, load_model=0)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _dirs(root):
    """The arms' result and checkpoint directories (the ones the script
    creates; the trainers add the summary directory)."""
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_dir() and p.name.startswith(("result-sweepK",
                                                       "checkpoint-sweepK")))


def _sweep_line(text):
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith('{"sweep"')][-1])["sweep"]


class _StubTrainer:
    """ladder_tpu's trainer as the JAX script uses it, without training."""

    def __init__(self, model, data, cfg):
        self.metrics = types.SimpleNamespace(val_loss_ave_epoch=[12.5],
                                             elbo_val=[-3.25])
        self.gm_fast = (np.array([0.6, 0.395, 0.005])[:cfg["n_mixtures"]],)

    def train(self):
        pass


def _run_jax(cfg_path, work, monkeypatch):
    import ladder_tpu.data.mnist
    import ladder_tpu.models.builder
    import ladder_tpu.training.trainer

    monkeypatch.setattr(ladder_tpu.training.trainer, "MNISTTrainer",
                        _StubTrainer)
    monkeypatch.setattr(ladder_tpu.models.builder, "make_model",
                        lambda cfg: None)
    monkeypatch.setattr(ladder_tpu.data.mnist, "DataGenerator",
                        lambda cfg: None)
    spec = importlib.util.spec_from_file_location(
        "jax_sweep_gmm", ROOT / "scripts" / "sweep_gmm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setattr(sys, "argv", ["sweep_gmm.py", "-c", cfg_path,
                                      "--mixtures", *ARMS, "--epochs", "1"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def test_sweep_matches_the_jax_script(tmp_path, monkeypatch, few_threads):  # noqa: F811
    cfg_path = _config(tmp_path)
    jax_text = _run_jax(cfg_path, tmp_path / "jax", monkeypatch)

    trainers = []
    train_arm = port.train_arm

    def keep(cfg, device):
        trainers.append(train_arm(cfg, device))
        return trainers[-1]

    monkeypatch.setattr(port, "train_arm", keep)
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = port.main(["-c", cfg_path, "--mixtures", *ARMS,
                             "--epochs", "1", "--device", "cpu"])
    port_text = buf.getvalue()

    assert _dirs(tmp_path / "port") == _dirs(tmp_path / "jax")
    assert len(_dirs(tmp_path / "port")) == 2 * len(ARMS)
    want, got = _sweep_line(jax_text), _sweep_line(port_text)
    assert got == results
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        assert g["n_mixtures"] == w["n_mixtures"]
        assert all(type(g[k]) is type(w[k]) for k in w)
        assert np.isfinite(g["final_val_loss"])
        assert np.isfinite(g["final_val_elbo"])
    table = [ln for ln in port_text.splitlines() if " | " in ln]
    jax_table = [ln for ln in jax_text.splitlines() if " | " in ln]
    assert table[0] == jax_table[0] and len(table) == len(jax_table)
    assert [ln.split(" | ")[0] for ln in table] == [
        ln.split(" | ")[0] for ln in jax_table]
    for r, trainer in zip(got, trainers):
        assert trainer.gm_fast is not None
        w = trainer.gm_fast[0].cpu().numpy()
        assert r["active_mixtures"] == int((w >= 1e-2).sum()) >= 1
        assert trainer.config["n_mixtures"] == r["n_mixtures"]
        assert trainer.config["enable_plots"] == 0
        assert trainer.config["load_model"] == 0
        assert trainer.config["result_dir"].rstrip("/").endswith(
            f"-sweepK{r['n_mixtures']}")
        assert trainer.device == torch.device("cpu")


def test_the_card_is_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.main(["-c", _config(tmp_path), "--mixtures", "3"])
