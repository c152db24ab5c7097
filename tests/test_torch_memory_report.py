"""python -m ladder_tpu_torch.memory_report against
scripts/memory_report.py on tests/test_scripts.py's tiny config, MNIST and
CelebA: the same state_mb (params, adam_m, adam_v: the logical bytes of
the train state) and batch_mb exactly, the peak fields null on the CPU,
one real step taken, and --mesh refused outside torchrun. The JAX script
runs with its train state traced and its compile stubbed (state_mb and
batch_mb read only the leaves' shapes and dtypes)."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from ladder_tpu_torch import memory_report as port
from tests.conftest import make_config
from tests.test_torch_losses import few_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {
    "mnist": dict(prior="ours", n_MC_samples=2, num_hidden_units=64,
                  num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
                  batch_size=16, fused_train_step=2),
    "celeba": dict(prior="ours", n_MC_samples=2, num_hidden_units=16,
                   num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
                   batch_size=4, fused_train_step=2, exp_name="celeba",
                   code_size=16, dim_input_x=128, dim_input_y=128,
                   dim_input_channel=3),
}


class _Lowered:
    def compile(self):
        return self

    def memory_analysis(self):
        return types.SimpleNamespace(
            argument_size_in_bytes=0, output_size_in_bytes=0,
            temp_size_in_bytes=0, alias_size_in_bytes=0,
            generated_code_size_in_bytes=0)


def _jax_report(cfg_path, argv, monkeypatch):
    """The JAX script's line with its train state traced, not computed
    (jax.eval_shape: the leaves' shapes and dtypes, which is all its
    state_mb reads; an eager CelebA init takes half a minute) and its
    compile stubbed."""
    import jax
    import ladder_tpu.training.step

    init = ladder_tpu.training.step.init_state
    monkeypatch.setattr(ladder_tpu.training.step, "init_state",
                        lambda model, rng: jax.eval_shape(
                            lambda key: init(model, key), rng))
    monkeypatch.setattr(ladder_tpu.training.step, "make_train_step",
                        lambda model: types.SimpleNamespace(
                            lower=lambda *a: _Lowered()))
    spec = importlib.util.spec_from_file_location(
        "jax_memory_report", ROOT / "scripts" / "memory_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(["--config", cfg_path, *argv]) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _port_report(cfg_path, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port.main(["--config", cfg_path, *argv,
                          "--device", "cpu"]) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("family,argv", [
    ("mnist", []), ("mnist", ["--fused", "1", "--batch", "8"]),
    ("celeba", []), ("celeba", ["--dtype", "bfloat16"])])
def test_state_and_batch_bytes_are_the_jax_scripts(
        family, argv, tmp_path, monkeypatch, few_threads):  # noqa: F811
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(make_config(**CONFIGS[family])))
    want = _jax_report(str(cfg_path), argv, monkeypatch)
    got = _port_report(str(cfg_path), argv)
    assert got["state_mb"] == want["state_mb"]
    assert got["state_mb"]["params"] > 0
    assert got["batch_mb"] == want["batch_mb"] > 0
    for key in ("config", "exp_name", "prior", "batch_size", "dtype",
                "fused_train_step", "steps_per_call", "mesh", "n_devices"):
        assert got[key] == want[key], key
    assert got["backend"] == want["backend"] == "cpu"
    assert got["measured_mb"] == dict.fromkeys(
        ("allocated_before", "peak_during_step", "step_increment",
         "reserved"))
    assert got["peak_estimate_mb"] is None


def test_the_step_is_taken_and_steps_per_call_reported(tmp_path, monkeypatch,
                                                       few_threads):  # noqa: F811
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(make_config(**CONFIGS["mnist"])))
    steps = []
    import ladder_tpu_torch.training.step as step_mod
    real = step_mod.make_train_step

    def counted(model, mesh=None):
        step = real(model, mesh)

        def run(state, *a, **k):
            out = step(state, *a, **k)
            steps.append(float(out[1]["ae"]["loss_ae"]))
            return out
        return run

    monkeypatch.setattr(step_mod, "make_train_step", counted)
    got = _port_report(str(cfg_path), ["--steps-per-call", "3",
                                       "--unroll", "2"])
    assert len(steps) == 1 and torch.isfinite(torch.tensor(steps[0]))
    assert got["steps_per_call"] == 3


def test_mesh_is_refused_outside_torchrun(tmp_path, monkeypatch):
    monkeypatch.delenv("LADDER_DISTRIBUTED", raising=False)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(make_config(**CONFIGS["mnist"])))
    with pytest.raises(RuntimeError, match="LADDER_DISTRIBUTED=1 torchrun "
                       "--standalone --nproc_per_node 4"):
        port.main(["--config", str(cfg_path), "--mesh", "2,2",
                   "--device", "cpu"])


def test_the_card_is_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.main(["--config", "codes/celeba_config.json"])


def test_mesh_under_torchrun_reports_each_ranks_bytes(tmp_path):
    """--mesh 1,2 as 2 gloo ranks on the CPU: one line from the lead, each
    rank holding the rule's bytes at rest, half the replicated state."""
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(make_config(**CONFIGS["celeba"])))
    env = dict(os.environ, LADDER_DISTRIBUTED="1", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "ladder_tpu_torch.memory_report",
         "--config", str(cfg_path), "--mesh", "1,2", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"')]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["mesh"] == "1,2" and rec["n_devices"] == 2
    assert [r["rank"] for r in rec["ranks"]] == [0, 1]
    full = round(sum(rec["state_mb"].values()) * 1e6)
    for r in rec["ranks"]:
        assert r["held"] == r["predicted"] < 0.55 * r["replicated"]
        assert abs(r["replicated"] - full) <= 0.015e6  # state_mb's rounding
        assert r["measured_mb"]["peak_during_step"] is None
