"""chip_smoke.py off the card: it refuses to run without CUDA, and its
serving and training phases run end to end on the CPU at a tiny width (the
rehearsal of what it drives on the card, where the kernel launches are
counted too)."""

import json
import types

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_serving import tiny_celeba


def test_exits_nonzero_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_serving_phase_rehearsal_on_cpu(tmp_path):
    cfg = tiny_celeba(tmp_path)
    run = chip_smoke.drive_serving(cfg, "cpu")
    assert run["launches"] == 0  # CPU tensors never launch the kernel
    assert [name for name, _ in run["calls"]] == [
        "reconstruct[64]", "reconstruct[3]", "encode", "represent", "decode",
        "decode_representation", "generate", "t_log_density",
        "reconstruct[64] bf16", "HTTP POST /reconstruct[3]"]
    assert run["gpu_cpu_max_abs"] == 0.0
    assert run["bf16_mean_abs"] <= chip_smoke.BF16_BAND_MEAN_ABS
    lat = chip_smoke.path_latencies(run["engine"], run["x"][:4], repeats=1)
    assert set(lat) == {"encode", "reconstruct", "represent", "decode",
                        "decode_representation", "generate"}


def test_training_phase_rehearsal_on_cpu(tmp_path):
    import jax
    from ladder_tpu.models.builder import make_model as jmake
    from ladder_tpu_torch.ops.distributions import gmm_cholesky

    cfg = tiny_celeba(tmp_path)
    params = jax.tree.map(np.asarray, jmake(cfg).init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    gm = dict(weights=torch.full((4,), 0.25),
              means=torch.tensor(rng.standard_normal((4, 2)), dtype=torch.float32),
              chols=gmm_cholesky(torch.stack([torch.eye(2) * 0.5] * 4)))
    images = rng.random((4, 128, 128, 3)).astype(np.float32)
    chip_smoke.reset_counters()
    train = chip_smoke.drive_training(cfg, params, gm, images, "cpu",
                                      steps=2, cpu_batch=2)
    assert set(train) == {1, 2}
    for mode, res in train.items():
        assert len(res["step_ms"]) == 2 and len(res["loss_ae"]) == 2
        assert res["state"]["step"] == 2
        # CPU tensors never launch a kernel
        assert not any(res["launches"].values())
        assert res["metric_gap"] == 0.0 and res["param_gap_max_lr"] == 0.0
    assert not any(chip_smoke.read_counters().values())


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
    assert (cfg["synthetic_n_train"], cfg["synthetic_n_test"]) == (60000,
                                                                    10000)
    # the updates of each group since the step counts of t_before
    trainer = types.SimpleNamespace(state={"opt": {
        "ae": {"t": 468}, "sigma": {"t": 468}, "prior": {"t": 234}}})
    assert chip_smoke.adam_updates(trainer, {"ae": 234, "sigma": 234}) == \
        {"ae": 234, "sigma": 234, "prior": 234}
    assert chip_smoke.adam_updates(trainer, {}) == \
        {"ae": 468, "sigma": 468, "prior": 234}


@pytest.mark.parametrize("mode, want", [
    (1, {"norm_chain_fwd": 16, "norm_chain_bwd": 4, "output_stage_fwd": 4,
         "output_stage_bwd": 1, "adam_update": 4}),
    (2, {"norm_chain_fwd": 4, "norm_chain_bwd": 4, "output_stage_fwd": 1,
         "output_stage_bwd": 1, "adam_update": 4})])
def test_expected_step_launches(tmp_path, mode, want):
    cfg = tiny_celeba(tmp_path)
    assert chip_smoke.expected_step_launches(cfg, mode, "cuda") == want
    assert not any(chip_smoke.expected_step_launches(cfg, mode,
                                                     "cpu").values())


def test_kernel_entries_cover_the_five_kernels():
    case = {"shape": [64, 128, 128, 128], "dtype": "float32",
            "max_abs_err": 1e-6, "ms": 0.4, "device_ms": 0.4,
            "call_ms": 0.5, "host_ms": 0.1, "plain_ms": 2.0,
            "bound_ms": 0.17, "bound_by": "bytes"}
    entries = [
        chip_smoke.output_stage_entry("output_stage_fwd", "f:1", [case], 3),
        chip_smoke.output_stage_entry(
            "output_stage_bwd", "f:2",
            [dict(case, ddec=True, ms=9.0), dict(case, ddec=False)], 1),
        chip_smoke.adam_entry([dict(case, group="scalar", tensors=1,
                                    elements=1),
                               dict(case, group="ae", tensors=72,
                                    elements=10)], 8)]
    for entry in entries:
        for key in ("name", "route", "source", "replaces", "launches",
                    "max_abs_err", "ms", "device_ms", "call_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms"):
            assert key in entry
        assert entry["ms"] == entry["device_ms"] == 0.4
        assert entry["call_ms"] == 0.5 and entry["route"] == "cuda"
        assert (chip_smoke.ROOT and
                __import__("os").path.isfile(entry["source"]))
    assert set(chip_smoke.kernel_counters()) == {
        "norm_chain_fwd", "norm_chain_bwd", "output_stage_fwd",
        "output_stage_bwd", "adam_update"}
    json.dumps({"kernels": entries})


def test_kernel_entry_has_the_contract_keys():
    cases = [{"shape": list(s), "dtype": dt, "stages_per_decode": k,
              "max_abs_err": 1e-7, "ms": 0.01, "device_ms": 0.01,
              "call_ms": 0.02, "plain_ms": 0.05, "bound_ms": 0.004,
              "bound_by": "bytes"}
             for s, k in chip_smoke.NORM_CHAIN_STAGES
             for dt in ("float32", "bfloat16")]
    # the L2-resident stage is also timed with the cache flushed
    for case in cases:
        if tuple(case["shape"]) == chip_smoke.L2_RESIDENT_STAGE:
            case["device_ms_l2_flushed"] = 0.03
    entry = chip_smoke.norm_chain_entry(cases, launches=28)
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "device_ms", "call_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms"):
        assert key in entry
    assert entry["route"] == "cuda" and entry["library_ms"] is None
    # four stages per decode; the 16x16 one with the L2 cache flushed
    assert entry["ms"] == entry["device_ms"] == pytest.approx(0.06)
    assert entry["device_ms_warm"] == pytest.approx(0.04)
    assert entry["call_ms"] == pytest.approx(0.08)
    assert entry["launches"] == 28
    json.dumps({"kernels": [entry]})


@pytest.mark.parametrize("name, key", [
    ("NVIDIA H100 80GB HBM3", "H100"), ("NVIDIA H100 PCIe", "H100 PCIe"),
    ("NVIDIA H100 NVL", "H100 NVL")])
def test_card_peaks(name, key):
    assert chip_smoke.card_peaks(name)[0] == key


def test_bf16_ulp():
    y = torch.tensor([1.0, 1.5, 2.0, -3.0, 0.0])
    ulp = chip_smoke._bf16_ulp(y)
    np.testing.assert_allclose(ulp[:4].numpy(), [2 ** -7, 2 ** -7, 2 ** -6,
                                                 2 ** -6])
    assert 0 < ulp[4] < 1e-30


def _celeba_groups(tmp_path, cfg):
    """A seeded model's two checkpoint groups at the rehearsal's width."""
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.utils.checkpoint import VAE_KEYS, save_msgpack
    params = make_model(cfg, seed=3).flax_params()
    groups = tmp_path / "groups"
    groups.mkdir()
    save_msgpack(str(groups / "vae-model.msgpack"),
                 {k: params[k] for k in VAE_KEYS})
    save_msgpack(str(groups / "prior-model.msgpack"),
                 {k: params[k] for k in ("prior", "inner_sigma")})
    return str(groups)


def test_celeba_phase_rehearsal_on_cpu(tmp_path, capsys):
    """Phase 6 on the CPU at h=16 with 32 + 16 + 8 synthetic images at
    batch 8: every check of the phase (the launches counted as none: CPU
    tensors never launch a kernel)."""
    overrides = dict(chip_smoke.CELEBA_OVERRIDES, num_hidden_units=16,
                     code_size=16, representation_size=2,
                     num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
                     n_mixtures=3, n_MC_samples=2, batch_size=8,
                     synthetic_n_train=32, synthetic_n_val=16,
                     synthetic_n_test=8)
    groups = _celeba_groups(tmp_path, chip_smoke.celeba_config(overrides))
    res = chip_smoke.drive_celeba("cpu", overrides=overrides, groups=groups,
                                  profile_steps=0, freeze_batches=2,
                                  serve_batch=8)
    first, resumed = res["runs"]
    assert first["epochs"] == (1, 2) and resumed["epochs"] == (3,)
    assert resumed["trainer"].cur_epoch == 3
    assert [t["epoch"] for t in resumed["trainer"].timings] == [3]
    assert [t["epoch"] for t in res["bf16"]["trainer"].timings] == [1]
    assert res["bf16"]["trainer"].model.dtype == torch.bfloat16
    for run in res["runs"] + [res["bf16"]]:
        assert not any(run["launches"].values())
        for t in run["trainer"].timings:
            assert not any(t["launches"].values())
    assert not any(res["serve"]["launches"].values())
    assert res["serve"]["line"]["batches"] == 2
    assert res["serve"]["row_gap"] <= chip_smoke.FROZEN_ROW_MAX_ABS
    assert res["artifacts"]["result_keys"] == sorted(chip_smoke.RESULT_KEYS)
    assert sorted(res["build_seconds"]) == [
        "celebA_test.tfrecords", "celebA_train.tfrecords",
        "celebA_val.tfrecords"]
    assert len(res["reader_s"]) == 4
    chip_smoke.log_celeba(res, "cpu")
    out = capsys.readouterr().out
    assert "Full train state restored (epoch 2)." in out
    assert "celeba float32 run to epoch 3 on cpu" in out
    assert "epoch 3: 4 steps" in out and "freeze_bn over 2 batches" in out


def test_result_keys_are_ladder_tpus(tmp_path):
    from ladder_tpu.utils.metrics import MetricsRecorder
    path = MetricsRecorder().save(
        {"result_dir": str(tmp_path), "exp_name": "celeba"}, [1, 2], 3, 4)
    assert sorted(np.load(path).files) == sorted(chip_smoke.RESULT_KEYS)


def test_celeba_phase_config():
    cfg = chip_smoke.celeba_config()
    assert (cfg["num_hidden_units"], cfg["code_size"],
            cfg["representation_size"], cfg["num_hidden_units_inner_VAE"],
            cfg["n_layers_inner_VAE"], cfg["n_mixtures"],
            cfg["n_MC_samples"], cfg["batch_size"], cfg["dim_input_x"]) == (
        512, 256, 32, 512, 5, 50, 100, 64, 128)
    assert (cfg["synthetic_n_train"], cfg["synthetic_n_val"],
            cfg["synthetic_n_test"], cfg["enable_plots"]) == (1024, 256, 128,
                                                              0)


@pytest.mark.parametrize("mode, overlap, want", [
    # 16 steps, 5 evaluation forwards (the test batch, 4 validation batches)
    (1, False, {"norm_chain_fwd": 16 * 16 + 20, "norm_chain_bwd": 64,
                "output_stage_fwd": 16 * 4 + 5, "output_stage_bwd": 16,
                "adam_update": 64}),
    (1, True, {"norm_chain_fwd": 16 * 16 + 20, "norm_chain_bwd": 64,
               "output_stage_fwd": 16 * 4 + 5, "output_stage_bwd": 16,
               "adam_update": 64}),
    (2, True, {"norm_chain_fwd": 16 * 8 + 20, "norm_chain_bwd": 64,
               "output_stage_fwd": 16 * 2 + 5, "output_stage_bwd": 16,
               "adam_update": 64}),
    (2, False, {"norm_chain_fwd": 16 * 4 + 20, "norm_chain_bwd": 64,
                "output_stage_fwd": 16 + 5, "output_stage_bwd": 16,
                "adam_update": 64})])
def test_expected_epoch_launches(mode, overlap, want):
    cfg = chip_smoke.celeba_config()
    assert chip_smoke.expected_epoch_launches(cfg, mode, 16, 5, overlap,
                                              "cuda") == want
    assert not any(chip_smoke.expected_epoch_launches(
        cfg, mode, 16, 5, overlap, "cpu").values())


def test_copy_overlap():
    """Pinned copies against merged kernel spans: the first copy lies
    under kernels for 8 of its 10 us, the second for none of its 5."""
    events = [("k1", 0.0, 6.0), ("k2", 4.0, 8.0), ("Memcpy HtoD (Pinned -> "
              "Device)", 0.0, 10.0), ("Memcpy HtoD (Pinned -> Device)",
                                      20.0, 25.0), ("k3", 30.0, 31.0),
              ("Memcpy HtoD (Pageable -> Device)", 40.0, 41.0)]
    n, us, share = chip_smoke.copy_overlap(events)
    assert (n, us) == (2, 15.0)
    assert share == pytest.approx(8.0 / 15.0)
    assert chip_smoke.copy_overlap([("k", 0.0, 1.0)]) == (0, 0, None)


def test_a_recorder_that_saw_no_step_fails():
    """A train step built around the recorder leaves it nothing to keep:
    the batch check then fails instead of checking nothing."""
    with chip_smoke._Recorder(2) as rec:
        pass
    with pytest.raises(AssertionError, match="kept 0 batches"):
        rec.kept("run")
    rec.batches = [torch.zeros(1), torch.zeros(1)]
    assert len(rec.kept("run")) == 2


def _groups(tmp_path, cfg, name):
    """A seeded model's checkpoint groups under tmp_path/name/<exp_name>,
    laid out as pretrained_models/ is; returns tmp_path/name."""
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.utils.checkpoint import VAE_KEYS, save_msgpack
    params = make_model(cfg, seed=3).flax_params()
    root = tmp_path / name
    (root / cfg["exp_name"]).mkdir(parents=True)
    save_msgpack(str(root / cfg["exp_name"] / "vae-model.msgpack"),
                 {k: params[k] for k in VAE_KEYS})
    save_msgpack(str(root / cfg["exp_name"] / "prior-model.msgpack"),
                 {k: params[k] for k in ("prior", "inner_sigma")})
    return str(root)


def _demo_cfg(path, overrides):
    import json
    import os
    from ladder_tpu_torch.utils.config import apply_defaults
    with open(os.path.join(chip_smoke.ROOT, path)) as f:
        cfg = json.load(f)
    cfg.update(overrides)
    return apply_defaults(cfg)


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
SMALL_CELEBA = dict(chip_smoke.INTERP_CELEBA_OVERRIDES, num_hidden_units=16,
                    code_size=16, representation_size=2,
                    num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
                    n_mixtures=3, n_MC_samples=2, batch_size=8,
                    synthetic_n_train=32, synthetic_n_val=16,
                    synthetic_n_test=8)
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
    assert chip_smoke.INTERP_ARGS[-1] == "500"
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
