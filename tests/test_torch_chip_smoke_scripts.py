"""chip_smoke.py's phase 12 rehearsed on the CPU at h=16 (a file of its
own, so that xdist runs it beside the other rehearsals): phase 11's
records at tiny widths, then verify_real_data check and compare on them,
sweep_gmm at two arms, memory_report at two cases, batch_quality_study at
batches 8 and 16 and the mode_parity sweep and combine, with every check
of the phase (the launches counted as none: CPU tensors never launch a
kernel). The sweep's six records come from a stand-in for its
``chip_smoke.py --quality-child`` subprocesses that writes phase 11's
CelebA record under each (mode, seed): a CelebA record on the CPU spends
~25 s in its accurate GM fit alone."""

import json
import os
import subprocess

import pytest

import chip_smoke
from ladder_tpu_torch import batch_quality_study, mode_parity
from tests.conftest import make_config
from tests.test_torch_losses import few_threads  # noqa: F401

SMALL = dict(num_hidden_units=16, n_mixtures=3, n_MC_samples=2,
             num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2)
CELEBA = dict(SMALL, code_size=16, batch_size=8)


def _phase11(work):
    digit = ("--config", "codes/mnist_digit_config.json", "--epochs", "3",
             "--n-train", "256", "--n-test", "128", "--fid-samples", "64",
             "--override", json.dumps(dict(SMALL, sg_pretraining=2,
                                           accurate_fit=1, batch_size=64,
                                           num_hidden_units=64)))
    celeba = ("--config", "codes/celeba_config.json", "--epochs", "1",
              "--n-train", "16", "--n-test", "8", "--fid-samples", "8")
    return chip_smoke.drive_quality(
        "cpu", digit_args=digit, celeba_args=celeba,
        celeba_overrides=dict(chip_smoke.QUALITY_CELEBA_OVERRIDES,
                              synthetic_n_val=8, **CELEBA),
        work=str(work / "quality"))


def test_scripts_phase_rehearsal_on_cpu(tmp_path, capsys, monkeypatch,
                                        few_threads):  # noqa: F811
    quality = _phase11(tmp_path)
    mnist = tmp_path / "mnist.json"
    mnist.write_text(json.dumps(make_config(
        **dict(SMALL, num_hidden_units=64, batch_size=64,
               synthetic_n_train=128, synthetic_n_test=64,
               sg_pretraining=1, accurate_fit=2))))
    celeba = tmp_path / "celeba.json"
    celeba.write_text(json.dumps(make_config(
        **dict(CELEBA, exp_name="celeba", dim_input_x=128, dim_input_y=128,
               dim_input_channel=3))))
    def child(cmd, cwd, env, stdout, stderr, timeout):
        """The --quality-child's files, from phase 11's CelebA record."""
        assert cmd[1:3] == [chip_smoke.__file__, "--quality-child"]
        argv = dict(zip(cmd[3::2], cmd[4::2]))
        fused, seed = int(argv["--fused"]), int(argv["--seed"])
        rec = dict(quality["celeba"]["record"], seed=seed,
                   final_val_neg_elbo=quality["celeba"]["record"][
                       "final_val_neg_elbo"] * (1 + 0.01 * seed + fused))
        with open(argv["--out"], "w") as f:
            json.dump(rec, f)
        head, tail = os.path.split(argv["--out"])
        with open(os.path.join(head, "launches_" + tail), "w") as f:
            json.dump({"launches": quality["celeba"]["launches"], "rc": 0}, f)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(mode_parity.subprocess, "run", child)
    real = batch_quality_study.run_one
    monkeypatch.setattr(
        batch_quality_study, "run_one",
        lambda b, args, lr_scale=1.0, overrides=None: real(
            b, args, lr_scale, overrides=dict(SMALL, code_size=16,
                                              accurate_fit=1)))
    res = chip_smoke.drive_scripts(
        "cpu", quality, str(tmp_path),
        sweep_gmm_kw=dict(config=str(mnist), overrides={},
                          args=("--mixtures", "3", "4", "--epochs", "2",
                                "--synthetic")),
        memory_kw=dict(config=str(celeba),
                       cases=((8, 1, "float32"), (8, 2, "bfloat16"))),
        batch_kw=dict(args=("--epochs", "1", "--n-train", "32",
                            "--batches", "8", "16", "--dtype", "float32")),
        mode_parity_kw=dict(args=(
            "--epochs", "1", "--n-train", "16",
            "--override", json.dumps(dict(
                CELEBA, sg_pretraining=0, accurate_fit=1, synthetic_n_val=8,
                synthetic_n_test=8)))))
    assert [c["rc"] for c in res["check"]] == [0, 0]
    assert res["compare"]["rc"] in (0, 1)
    assert [r["n_mixtures"] for r in res["sweep_gmm"]["rows"]] == [3, 4]
    assert [m["report"]["batch_size"] for m in res["memory"]] == [8, 8]
    assert all(m["report"]["peak_estimate_mb"] is None
               for m in res["memory"])
    assert [r["lr_scale"] for r in res["batch_study"]["payload"]["runs"]] \
        == [1.0, 2.0]
    assert sorted(res["mode_parity"]["records"]) == [
        f"m{m}_s{s}" for m in (1, 2) for s in (0, 1, 2)]
    assert set(res["mode_parity"]["combined"]["metrics"]) == set(
        mode_parity.KEYS)
    assert not any(res["launches"].values())
    chip_smoke.log_scripts(res, "cpu")
    out = capsys.readouterr().out
    for part in ("verify_real_data check (mnist_digit)",
                 "verify_real_data compare", "sweep_gmm on cpu",
                 "memory_report batch 8 mode 2 bfloat16",
                 "batch_quality_study on cpu", "mode_parity sweep"):
        assert part in out


def test_scripts_phase_configs():
    """Phase 12 at the published widths: only data, epochs and batches
    cut; the sweep's last epoch ends in the first fast fit."""
    from ladder_tpu_torch.utils.config import process_config
    digit = process_config(f"{chip_smoke.ROOT}/{chip_smoke.SWEEP_GMM_CONFIG}")
    args = chip_smoke.SWEEP_GMM_ARGS
    assert int(args[args.index("--epochs") + 1]) == digit["sg_pretraining"]
    assert set(chip_smoke.SWEEP_GMM_OVERRIDES) == {"synthetic_n_train",
                                                   "synthetic_n_test"}
    celeba = process_config(f"{chip_smoke.ROOT}/{chip_smoke.MEMORY_CONFIG}")
    assert (celeba["num_hidden_units"], celeba["code_size"]) == (512, 256)
    assert chip_smoke.MEMORY_CASES == ((64, 1, "float32"),
                                       (64, 2, "float32"),
                                       (64, 2, "bfloat16"),
                                       (256, 2, "bfloat16"))
    override = json.loads(chip_smoke.MODE_PARITY_ARGS[
        chip_smoke.MODE_PARITY_ARGS.index("--override") + 1])
    assert set(override) == {"sg_pretraining", "accurate_fit",
                             "synthetic_n_val", "synthetic_n_test"}
    assert override["synthetic_n_val"] >= 512  # a full-rank CelebA FID



@pytest.mark.parametrize("mode, want", [
    (1, {"norm_chain_fwd": 8, "norm_chain_bwd": 4, "output_stage_fwd": 2,
         "output_stage_bwd": 1, "adam_update": 2}),
    (2, {"norm_chain_fwd": 4, "norm_chain_bwd": 4, "output_stage_fwd": 1,
         "output_stage_bwd": 1, "adam_update": 2})])
def test_launches_before_prior_training(mode, want):
    """An epoch before sg_pretraining's last (batch_quality_study's first
    at sg_pretraining 2) updates only the ae and sigma groups."""
    cfg = chip_smoke.celeba_config()
    assert chip_smoke.expected_step_launches(cfg, mode, "cuda",
                                             do_prior=False) == want
    epoch = chip_smoke.expected_epoch_launches(cfg, mode, 16, 3, False,
                                               "cuda", do_prior=False)
    assert epoch == {k: 16 * v + {"norm_chain_fwd": 12,
                                  "output_stage_fwd": 3}.get(k, 0)
                     for k, v in want.items()}
