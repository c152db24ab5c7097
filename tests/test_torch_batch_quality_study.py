"""python -m ladder_tpu_torch.batch_quality_study against
scripts/batch_quality_study.py: run_one trains the recipe at tiny widths
(its overrides) at batches 8 and 16 with the port's CelebATrainer; the
record has the JAX script's schema, meta and lr scaling (the JAX main run
with its run_one stubbed, so it trains nothing), finite curves one point
an epoch, and the JAX package's docs/batch_quality_study.json is never
the port's output."""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ladder_tpu_torch import batch_quality_study as port
from tests.test_torch_losses import few_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--epochs", "2", "--n-train", "32", "--batches", "8", "16",
        "--sg-pretraining", "1", "--dtype", "float32"]
# the widths of tests/test_torch_celeba_trainer.py:TINY
TINY = {"num_hidden_units": 16, "code_size": 16, "n_MC_samples": 2,
        "n_mixtures": 3, "num_hidden_units_inner_VAE": 8,
        "n_layers_inner_VAE": 2, "accurate_fit": 1}


def _jax_main(tmp_path, monkeypatch):
    """The JAX script's main over ARGV with run_one recording its calls:
    (the record it writes, [(batch, lr_scale)], its printed text)."""
    spec = importlib.util.spec_from_file_location(
        "jax_batch_quality_study",
        ROOT / "scripts" / "batch_quality_study.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = []

    def run_one(batch, args, lr_scale=1.0):
        calls.append((batch, lr_scale))
        return dict(batch=batch, lr_scale=lr_scale, wall_s=1.0,
                    train_neg_elbo=[2.0, 1.0], val_neg_elbo=[2.5, 1.5],
                    sigma=[0.4, 0.3], code_elbo_last=-1.0)

    monkeypatch.setattr(mod, "run_one", run_one)
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["batch_quality_study.py", *ARGV,
                                      "--out", str(out)])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return json.loads(out.read_text()), calls, buf.getvalue()


def test_study_matches_the_jax_script(tmp_path, monkeypatch, few_threads):  # noqa: F811
    want, calls, jax_text = _jax_main(tmp_path, monkeypatch)
    args = port.parse_args(ARGV + ["--device", "cpu"])
    got = port.study(args, overrides=TINY)
    assert got["meta"] == want["meta"]
    assert [(r["batch"], r["lr_scale"]) for r in got["runs"]] == calls \
        == [(8, 1.0), (16, 2.0)]
    for run, ref in zip(got["runs"], want["runs"]):
        assert list(run) == list(ref)
        for key in ("train_neg_elbo", "val_neg_elbo", "sigma"):
            assert len(run[key]) == args.epochs
            assert np.isfinite(run[key]).all()
        assert run["wall_s"] > 0 and np.isfinite(run["code_elbo_last"])
    assert "=== batch quality study ===" in jax_text


def test_main_writes_the_ports_record_and_prints_the_table(
        tmp_path, monkeypatch, capsys):
    def run_one(batch, args, lr_scale=1.0, overrides=None):
        return dict(batch=batch, lr_scale=lr_scale, wall_s=1.0,
                    train_neg_elbo=[2.0, 1.0], val_neg_elbo=[2.5, 1.5],
                    sigma=[0.4, 0.3], code_elbo_last=-1.0)

    _, _, jax_text = _jax_main(tmp_path, monkeypatch)
    monkeypatch.setattr(port, "run_one", run_one)
    out = tmp_path / "port.json"
    port.main(ARGV + ["--out", str(out), "--device", "cpu"])
    text = capsys.readouterr().out
    assert json.loads(out.read_text())["runs"][1]["lr_scale"] == 2.0
    assert text.replace(str(out), "OUT") == jax_text.replace(
        str(tmp_path / "jax.json"), "OUT")
    default = port.parse_args(["--device", "cpu"])
    assert default.out == "docs/batch_quality_study_torch.json"
    assert (default.epochs, default.n_train, default.batches,
            default.dtype) == (6, 4096, [64, 256], "bfloat16")
    with pytest.raises(SystemExit):
        port.parse_args(["--out", "docs/batch_quality_study.json"])


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.run_one(8, port.parse_args([]))
