"""chip_smoke.py's serving phase (3) rehearsed on the CPU at a tiny width."""

import chip_smoke
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)
from tests.test_torch_serving import tiny_celeba


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


def test_bench_serving_part_rehearsal_on_cpu(tmp_path, monkeypatch):
    """Phase 3's bench_serving part on the tiny model, its GM fit where the
    config's directory scheme puts it (so generate runs too), at batch 4
    in float32 (bf16 convolutions are slow on the CPU; the port's line in
    bf16 is held against the JAX script's in test_torch_bench_serving.py):
    every check of the part; the decoding calls counted, the launches none
    on the CPU."""
    import json
    import os

    import numpy as np
    import torch

    from ladder_tpu_torch.serving import engine as serving
    from ladder_tpu_torch.utils.config import process_config
    from tests.conftest import make_config

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(make_config(
        exp_name="celeba", prior="ours", dim_input_x=128, dim_input_y=128,
        dim_input_channel=3, num_hidden_units=16, code_size=8,
        num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
        representation_size=2, n_mixtures=4)))
    monkeypatch.chdir(tmp_path)
    result_dir = process_config(str(path))["result_dir"]
    os.makedirs(result_dir)
    rng = np.random.default_rng(0)
    np.savez(os.path.join(result_dir, "GM_prior_info.npz"),
             w_full=np.full((4,), 0.25, np.float32),
             m_full=rng.standard_normal((4, 2)).astype(np.float32),
             K_full=np.stack([np.eye(2, dtype=np.float32) * 0.5] * 4))
    before = (serving.run_path, serving.InferenceEngine._render)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # 16 request threads share the worker's cores
    try:
        runs = chip_smoke.drive_bench_serving(
            "cpu", config=str(path),
            runs=(("--batch", "4", "--dtype", "float32", "--iters", "1"),))
    finally:
        torch.set_num_threads(threads)
    assert (serving.run_path, serving.InferenceEngine._render) == before
    assert [r["record"]["dtype"] for r in runs] == ["float32"]
    for r in runs:
        assert list(r["record"]) == [
            *chip_smoke.BENCH_SERVING_KEYS[:10], "generate_img_s",
            *chip_smoke.BENCH_SERVING_KEYS[10:]]
        assert r["decodes"] > 0 and r["launches"] == 0


def test_bench_serving_part_at_the_published_widths():
    """The part runs the JAX script's config at batch 64 (h=512), its
    defaults, then float32."""
    from ladder_tpu_torch import bench_serving
    from ladder_tpu_torch.utils.config import process_config

    cfg = process_config(f"{chip_smoke.ROOT}/{chip_smoke.BENCH_SERVING_CONFIG}")
    assert (cfg["num_hidden_units"], cfg["code_size"]) == (512, 256)
    args = [bench_serving.parse_args(list(extra))
            for extra in chip_smoke.BENCH_SERVING_RUNS]
    assert [(a.batch, a.dtype, a.iters, a.mesh, a.config) for a in args] == [
        (64, "bfloat16", 50, 0, chip_smoke.BENCH_SERVING_CONFIG),
        (64, "float32", 20, 0, chip_smoke.BENCH_SERVING_CONFIG)]
