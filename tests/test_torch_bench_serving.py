"""The port's serving benchmark (python -m ladder_tpu_torch.bench_serving)
against the JAX package's scripts/bench_serving.py, loaded with importlib
(never imported by the port), both on the CPU on a narrow mnist_digit
config: the same JSON line, key for key and in order; the device-rate path
is the engine's public path; a frozen-BN CelebA engine benches too."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ladder_tpu_torch import bench_serving
from ladder_tpu_torch.serving import InferenceEngine
from ladder_tpu_torch.serving.engine import run_path
from tests.conftest import make_config
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--batch", "8", "--iters", "2"]
# 16 threads x 8 requests, plus the Batcher's warm-up request
REQUESTS = 16 * 8 + 1


def _write(tmp_path, cfg):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def narrow_mnist(tmp_path):
    """The mnist_digit recipe at narrow widths, its directories in tmp_path
    (no checkpoint there: both packages serve random weights)."""
    return _write(tmp_path, make_config(
        num_hidden_units=64, num_hidden_units_inner_VAE=8, code_size=4,
        n_mixtures=3, result_dir=str(tmp_path / "result") + "/",
        checkpoint_dir=str(tmp_path / "ckpt") + "/"))


def _last_json(out):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def jax_line(monkeypatch, capsys, argv):
    spec = importlib.util.spec_from_file_location(
        "jax_bench_serving", ROOT / "scripts" / "bench_serving.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setenv("LADDER_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(sys, "argv", ["bench_serving.py", *argv])
    mod.main()
    return _last_json(capsys.readouterr().out)


def port_line(capsys, argv):
    record = bench_serving.main([*argv, "--device", "cpu"])
    line = _last_json(capsys.readouterr().out)
    assert line == record
    return line


def _rates(line):
    out = {k: v for k, v in line.items() if k.endswith("_img_s")}
    c = line["concurrent_1img_req_s"]
    out.update(direct=c["direct"], micro_batched=c["micro_batched"])
    out.update(line["bucket_latency_ms"])
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_line_is_the_jax_scripts(tmp_path, monkeypatch, capsys, dtype):
    monkeypatch.chdir(tmp_path)
    argv = ["--config", narrow_mnist(tmp_path), *ARGS, "--dtype", dtype]
    want = jax_line(monkeypatch, capsys, argv)
    got = port_line(capsys, argv)
    assert list(got) == list(want)
    for key in ("metric", "batch", "dtype", "buckets"):
        assert got[key] == want[key]
    assert got["buckets"] == [1, 8] and got["dtype"] == dtype
    assert list(got["bucket_latency_ms"]) == list(want["bucket_latency_ms"])
    assert list(got["concurrent_1img_req_s"]) == list(
        want["concurrent_1img_req_s"])
    assert (got["concurrent_1img_req_s"]["requests"]
            == want["concurrent_1img_req_s"]["requests"] == REQUESTS)
    assert 1 <= got["concurrent_1img_req_s"]["batches"] <= REQUESTS
    for line in (got, want):
        rates = _rates(line)
        assert len(rates) == 6 + 2 + len(line["buckets"])
        assert all(np.isfinite(v) and v > 0 for v in rates.values()), rates


@pytest.mark.parametrize("name", ["reconstruct", "encode", "decode"])
def test_device_rate_runs_the_public_path(tmp_path, name):
    """device_rate times run_path under the engine's _device_call on the
    input it puts on the device: the public path's numbers."""
    cfg = json.loads(Path(narrow_mnist(tmp_path)).read_text())
    engine = InferenceEngine(cfg, serve_batch=8, allow_uninitialized=True,
                             device="cpu")
    rng = np.random.default_rng(1)
    if name == "decode":
        x = rng.standard_normal((8, cfg["code_size"])).astype(np.float32)
        xd = torch.tensor(x)
    else:
        x = rng.integers(0, 256, (8, 28, 28, 1)).astype(np.uint8)
        xd = engine._images(x)
    with engine._device_call():
        got = run_path(engine.model, name, xd)
    want = getattr(engine, name)(x)
    for g, w in zip(got if name == "encode" else (got,),
                    want if name == "encode" else (want,)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)
    assert bench_serving.device_rate(engine, name, x, iters=2) > 0



@pytest.mark.parametrize("name", ["reconstruct", "decode"])
def test_device_rate_times_every_replica(tmp_path, monkeypatch, name):
    """On a mesh of two CPU replicas device_rate runs the path on each
    replica's own half of the batch, warm-up and timed calls alike."""
    from ladder_tpu_torch.serving import engine as serving
    cfg = json.loads(Path(narrow_mnist(tmp_path)).read_text())
    engine = InferenceEngine(cfg, serve_batch=8, mesh_devices=2,
                             devices=["cpu", "cpu"], allow_uninitialized=True,
                             device="cpu")
    calls = []
    real = serving.run_path

    def counted(model, path, x):
        calls.append((engine._replicas.index(model), path, x.shape[0]))
        return real(model, path, x)

    monkeypatch.setattr(serving, "run_path", counted)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((8, cfg["code_size"])).astype(np.float32)
         if name == "decode"
         else rng.integers(0, 256, (8, 28, 28, 1)).astype(np.uint8))
    assert bench_serving.device_rate(engine, name, x, iters=2) > 0
    assert sorted(calls) == sorted((i, name, 4) for i in (0, 1)
                                   for _ in range(3 + 2))


def test_frozen_bn_celeba(tmp_path, monkeypatch, capsys):
    """--bn-stats on a narrow CelebA-128 config: the JAX script's keys (as
    test_line_is_the_jax_scripts reads them) and positive rates. The JAX
    script itself is not run here: its CelebA engine takes ~45 s to compile
    on the CPU."""
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.serving import bn_freeze

    monkeypatch.chdir(tmp_path)
    cfg = make_config(exp_name="celeba", prior="ours", dim_input_x=128,
                      dim_input_y=128, dim_input_channel=3,
                      num_hidden_units=16, code_size=8,
                      num_hidden_units_inner_VAE=8, n_layers_inner_VAE=2,
                      n_mixtures=3, result_dir=str(tmp_path / "result") + "/",
                      checkpoint_dir=str(tmp_path / "ckpt") + "/")
    params = make_model(cfg, seed=0).flax_params()
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (4, 128, 128, 3), dtype=np.uint8)]
    stats = bn_freeze.estimate_bn_stats(cfg, params, batches, device="cpu")
    bn = str(tmp_path / "bn_stats.npz")
    bn_freeze.save_bn_stats(bn, stats)
    line = port_line(capsys, ["--config", _write(tmp_path, cfg), "--batch",
                              "4", "--iters", "1", "--dtype", "float32",
                              "--bn-stats", bn])
    assert list(line) == [
        "metric", "batch", "dtype", "buckets", "reconstruct_img_s",
        "decode_img_s", "encode_img_s", "reconstruct_device_img_s",
        "decode_device_img_s", "encode_device_img_s", "bucket_latency_ms",
        "concurrent_1img_req_s"]
    assert line["buckets"] == [1, 4]
    assert line["concurrent_1img_req_s"]["requests"] == REQUESTS
    assert all(v > 0 for v in _rates(line).values())


def test_the_card_is_the_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_serving.main(["--config", narrow_mnist(tmp_path), *ARGS])
