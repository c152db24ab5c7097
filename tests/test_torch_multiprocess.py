"""The port's train CLI as 2 data-parallel ranks on the CPU:

    LADDER_DISTRIBUTED=1 torchrun --standalone --nproc_per_node 2 \\
        -m ladder_tpu_torch.train --config cfg.json --device cpu

on a tiny mnist_digit 'ours' config with mesh_shape [2], 2 epochs and
then a resume to 3, against the same CLI in one process
(no LADDER_DISTRIBUTED: the one device, whatever mesh_shape says). The two
runs consume the same random draws (each rank keeps its rows of the global
batch's), so their curves agree to the order of the float32 sums: within
rtol 2e-3, tests/test_multiprocess.py:200-212's band for ladder_tpu's two
processes against one. The ranks end bitwise equal (a digest of their
parameters, moments and GM fits, from ``--report``), each artifact is
written once, by the lead (the same files as one process's; one summary
line per epoch), and both ranks resume from the full train state. Plots
are off in these runs (matplotlib's PDFs would take most of their time); a
trainer that is not the lead is trained with plots on in this process and
writes no file at all.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ladder_tpu_torch import train as ttrain
from tests.conftest import make_config
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
N_TRAIN, BATCH = 256, 64
TINY = dict(num_epochs=2, sg_pretraining=1, accurate_fit=2,
            synthetic_data=1, synthetic_n_train=N_TRAIN,
            synthetic_n_test=128, num_hidden_units=64,
            num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
            n_MC_samples=4, n_mixtures=4, enable_plots=0, batch_size=BATCH,
            load_dir="default", load_model=1, mesh_shape=[2])
CURVE_RTOL = 2e-3


def _config(path, **kw):
    path.write_text(json.dumps(make_config(**{**TINY, **kw})))
    return str(path)


def _launch(workdir, config):
    env = dict(os.environ, LADDER_DISTRIBUTED="1", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "ladder_tpu_torch.train",
         "--config", config, "--device", "cpu",
         "--report", "report{rank}.json"],
        cwd=workdir, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _wait(proc):
    out = proc.communicate(timeout=300)[0]
    if proc.returncode != 0:
        raise AssertionError(f"torchrun exited {proc.returncode}:\n"
                             f"{out[-4000:]}")
    return out


def _one_process(workdir, config):
    old = os.getcwd()
    os.chdir(workdir)
    try:
        return ttrain.main(["--config", config, "--device", "cpu",
                            "--report", "report{rank}.json"])
    finally:
        os.chdir(old)


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file() and "experiments" in p.parts)


def _reports(root):
    return [json.loads((root / f"report{r}.json").read_text())
            for r in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank run and the one-process run, each trained 2 epochs
    (kept as copies of their file sets) and then resumed to 3; the ranks
    run while this process trains its one-process copy."""
    tmp = tmp_path_factory.mktemp("multiprocess")
    (tmp / "one").mkdir()
    (tmp / "two").mkdir()
    out = {}
    for stage, epochs in (("train", 2), ("resume", 3)):
        cfg = _config(tmp / f"{stage}.json", num_epochs=epochs)
        proc = _launch(tmp / "two", cfg)
        one = _one_process(tmp / "one", cfg)
        log = _wait(proc)
        out[stage] = dict(log=log, one=one, files=_files(tmp / "two"),
                          one_files=_files(tmp / "one"),
                          reports=_reports(tmp / "two"),
                          npz=_result(tmp / "two"), one_npz=_result(
                              tmp / "one"),
                          scalars=_scalars(tmp / "two"))
    return out


def _result(root):
    (path,) = root.rglob("mnist_digit-result.npz")
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _scalars(root):
    (path,) = root.rglob("scalars.jsonl")
    return path.read_text().splitlines()


@pytest.mark.parametrize("stage", ["train", "resume"])
def test_curves_equal_one_process(runs, stage):
    got, want = runs[stage]["npz"], runs[stage]["one_npz"]
    assert set(got) == set(want)
    for key in want:
        a, b = np.asarray(got[key], float), np.asarray(want[key], float)
        assert a.shape == b.shape, key
        np.testing.assert_allclose(a, b, rtol=CURVE_RTOL, atol=1e-6,
                                   err_msg=key)
    assert len(want["train_loss"]) == (N_TRAIN // BATCH) * (
        2 if stage == "train" else 3)


@pytest.mark.parametrize("stage", ["train", "resume"])
def test_ranks_end_bitwise_equal(runs, stage):
    reports = runs[stage]["reports"]
    assert [r["rank"] for r in reports] == [0, 1]
    assert all(r["world"] == 2 and r["backend"] == "gloo" for r in reports)
    assert reports[0]["digest"] == reports[1]["digest"]
    assert reports[0]["train_loss"] == reports[1]["train_loss"]
    epochs = 2 if stage == "train" else 3
    assert all(r["step"] == epochs * N_TRAIN // BATCH for r in reports)
    # the step loop's gradient all-reduces: one per optimiser group per
    # step in mode 1 (ae, sigma, prior and inner_sigma once prior training
    # starts after sg_pretraining's epoch)
    first = reports[0]["timings"][0]
    assert first["collectives"]["grad"]["calls"] >= 2 * N_TRAIN // BATCH


@pytest.mark.parametrize("stage", ["train", "resume"])
def test_each_artifact_written_once_by_the_lead(runs, stage):
    run = runs[stage]
    two = [f for f in run["files"] if "training_config_" not in f]
    one = [f for f in run["one_files"] if "training_config_" not in f]
    assert two == one
    assert "GM_prior_info.npz" in " ".join(two)
    # appended once per epoch: a second writer would double the lines
    epochs = 2 if stage == "train" else 3
    assert len(run["scalars"]) == epochs
    assert run["log"].count("Saving model...") == epochs - (
        2 if stage == "resume" else 0)


def test_both_ranks_resume(runs):
    """The resume trained epoch 3 only, on both ranks, from epoch 2's full
    state: the curves continue the 2-epoch run's."""
    assert "Full train state restored (epoch 2)." in runs["resume"]["log"]
    before, after = runs["train"]["npz"], runs["resume"]["npz"]
    n = len(before["train_loss"])
    np.testing.assert_array_equal(after["train_loss"][:n],
                                  before["train_loss"])
    for r in runs["resume"]["reports"]:
        assert [t["epoch"] for t in r["timings"]] == [3]


def test_a_rank_other_than_the_lead_writes_no_file(tmp_path):
    """Every write of the trainer (checkpoints, the train state, the result
    npz, the GM npz, the scalar summary, every plot) is the lead's: a
    trainer on a 1-rank mesh that says it is not the lead trains an epoch
    with plots on and leaves its directories empty, its metrics recorded
    all the same."""
    import socket

    from torch import distributed as dist

    from ladder_tpu_torch.data.mnist import DataGenerator
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.parallel.mesh import DataMesh
    from ladder_tpu_torch.training.trainer import MNISTTrainer
    from ladder_tpu_torch.utils.config import create_dirs

    cfg = make_config(**{**TINY, "num_epochs": 1, "sg_pretraining": 0,
                         "accurate_fit": 1, "enable_plots": 1,
                         "representation_size": 3})
    for key in ("result_dir", "checkpoint_dir", "summary_dir"):
        cfg[key] = str(tmp_path / key) + "/"
    create_dirs([cfg["result_dir"], cfg["checkpoint_dir"]])
    class NotLead(DataMesh):
        is_lead = False

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{port}")
    try:
        trainer = MNISTTrainer(make_model(cfg), DataGenerator(cfg), cfg,
                               device="cpu",
                               mesh=NotLead(0, 1, "cpu", backend="gloo"))
        trainer.train()
    finally:
        dist.destroy_process_group()
    assert len(trainer.metrics.train_loss) == N_TRAIN // BATCH
    assert trainer.gm_final is not None
    assert [p for p in tmp_path.rglob("*") if p.is_file()] == []
