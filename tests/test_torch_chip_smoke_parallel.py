"""chip_smoke.py's torchrun phase (9) rehearsed on the CPU at a tiny width."""

import chip_smoke
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)
from tests.torch_chip_smoke_helpers import _celeba_groups


def test_parallel_phase_rehearsal_on_cpu(tmp_path, capsys):
    """Phase 9 on the CPU at h=16: torchrun's ranks over gloo on the CPU,
    the NCCL rank replaced by one gloo rank; every check of the phase
    (the launches counted as none: CPU tensors never launch a kernel).
    Unprofiled: the CPU profiler's cost would double the rehearsal;
    tests/test_torch_parallel.py holds the trace's summary."""
    overrides = dict(chip_smoke.PARALLEL_OVERRIDES, num_hidden_units=16,
                     code_size=16, representation_size=2,
                     num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
                     n_mixtures=3, n_MC_samples=2, batch_size=8,
                     synthetic_n_train=32, synthetic_n_val=16,
                     synthetic_n_test=8)
    groups = _celeba_groups(tmp_path, chip_smoke.celeba_config(overrides))
    scaled = dict(chip_smoke.SCALED_OVERRIDES, num_hidden_units=16,
                  code_size=16, num_hidden_units_inner_VAE=16,
                  n_layers_inner_VAE=2, n_MC_samples=2, batch_size=8,
                  synthetic_n_train=32, synthetic_n_val=16,
                  synthetic_n_test=8)
    mnist = dict(chip_smoke.PARALLEL_MNIST_OVERRIDES, synthetic_n_train=256,
                 synthetic_n_test=128, batch_size=64, n_MC_samples=4)
    res = chip_smoke.drive_parallel("cpu", overrides=overrides,
                                    scaled_overrides=scaled,
                                    mnist_overrides=mnist, groups=groups,
                                    profile=False)
    runs = res["runs"]
    assert sorted(runs) == ["mnist_one", "mnist_ranks", "mnist_resumed",
                            "parity_nccl", "parity_one", "parity_ranks",
                            "scaled_one", "scaled_ranks"]
    assert [r["world"] for r in runs["parity_ranks"]["reports"]] == [2, 2]
    assert "first_loss_gap" in runs["parity_ranks"]
    assert not any(chip_smoke.parallel_launches(res).values())
    chip_smoke.log_parallel(res, "cpu")
    out = capsys.readouterr().out
    assert "gradient all-reduce" in out and "first-step loss gap" in out
