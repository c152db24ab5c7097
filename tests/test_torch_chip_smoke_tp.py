"""chip_smoke.py's phase 10 (the (data, model) mesh, the engine's
mesh_devices) rehearsed on the CPU at a tiny size, in a file of its own
so that it runs beside the other phases' rehearsals
(tests/test_torch_chip_smoke_<phase>.py)."""

import json

import numpy as np

import chip_smoke
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)
from tests.torch_chip_smoke_helpers import _celeba_groups, _demo_cfg, _groups


def test_tp_phase_rehearsal_on_cpu(tmp_path, capsys):
    """Phase 10 on the CPU at h=16: torchrun's ranks over gloo on the CPU
    (2 ranks on mesh_shape [1, 2], 2 steps an epoch; the mnist runs too:
    tests/test_torch_tp.py runs 4 ranks on [2, 2]), the engine and the
    serve CLI on a seeded CelebA model with its GM; every check of the
    phase (the launches counted as none: CPU tensors never launch a
    kernel)."""
    from ladder_tpu_torch.utils.checkpoint import save_gm_prior_info

    small = dict(num_hidden_units=16, code_size=16, representation_size=2,
                 num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
                 n_mixtures=3, n_MC_samples=2)
    overrides = dict(chip_smoke.TP_OVERRIDES, batch_size=8,
                     synthetic_n_train=16, synthetic_n_val=8,
                     synthetic_n_test=8, **small)
    groups = _celeba_groups(tmp_path, chip_smoke.celeba_config(overrides))
    served = _groups(tmp_path, _demo_cfg(chip_smoke.CONFIG, small), "served")
    save_gm_prior_info(f"{served}/celeba", np.full(3, 1 / 3),
                       np.random.default_rng(0).standard_normal((3, 2)),
                       np.stack([np.eye(2)] * 3))
    with open(f"{chip_smoke.ROOT}/{chip_smoke.CONFIG}") as f:
        raw = dict(json.load(f), load_dir=served + "/", **small)
    (tmp_path / "served.json").write_text(json.dumps(raw))
    mnist = dict(chip_smoke.TP_MNIST_OVERRIDES, synthetic_n_train=128,
                 synthetic_n_test=64, batch_size=64, n_MC_samples=4,
                 mesh_shape=[1, 2])
    res = chip_smoke.drive_tp("cpu", overrides=overrides,
                              mnist_overrides=mnist, groups=groups,
                              mnist_ranks=2, profile=False,
                              serve_config=str(tmp_path / "served.json"),
                              serve_batch=4, serve_generate=4)
    runs = res["runs"]
    assert sorted(runs) == ["celeba_one", "celeba_ranks", "celeba_resumed",
                            "mnist_one", "mnist_ranks", "mnist_resumed"]
    assert [(r["world"], r["n_model"])
            for r in runs["mnist_ranks"]["reports"]] == [(2, 2)] * 2
    assert res["files_equal"] == list(chip_smoke.CHECKPOINT_FILES)
    assert not any(chip_smoke.tp_launches(res).values())
    chip_smoke.log_tp(res, "cpu")
    out = capsys.readouterr().out
    assert "param_gather" in out and "at rest" in out
    assert "bitwise equal" in out
