"""chip_smoke.py's serving phase (3) rehearsed on the CPU at a tiny width."""

import chip_smoke
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
