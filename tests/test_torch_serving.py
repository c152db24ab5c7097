"""The slice as a whole: a tiny CelebA 'ours' checkpoint written by
ladder_tpu, served by both engines on the CPU; the port's CLI, HTTP server
and micro-batching; device selection without a card."""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ladder_tpu.models.builder import make_model as jmake
from ladder_tpu.serving import InferenceEngine as JaxEngine
from ladder_tpu.serving.bn_freeze import save_bn_stats
from ladder_tpu.utils.checkpoint import CheckpointManager, save_gm_prior_info
from ladder_tpu_torch import serve as tserve
from ladder_tpu_torch.ops import norm_chain as nc
from ladder_tpu_torch.serving import Batcher, InferenceEngine

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)


def tiny_celeba(tmp_path, seed=0):
    """A CelebA 'ours' model at h=16, code 8, inner VAE 16x2, t in 2-D,
    saved through ladder_tpu's checkpoint and GM artifacts."""
    from tests.conftest import make_config

    cfg = make_config(exp_name="celeba", prior="ours", dim_input_x=128,
                      dim_input_y=128, dim_input_channel=3,
                      num_hidden_units=16, code_size=8,
                      num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
                      representation_size=2, n_mixtures=4)
    cfg["checkpoint_dir"] = str(tmp_path / "ckpt") + "/"
    cfg["result_dir"] = str(tmp_path / "result") + "/"
    os.makedirs(cfg["checkpoint_dir"], exist_ok=True)
    os.makedirs(cfg["result_dir"], exist_ok=True)
    params = jmake(cfg).init(jax.random.PRNGKey(seed))
    CheckpointManager(cfg).save({"params": params}, model="joint")
    rng = np.random.default_rng(seed)
    save_gm_prior_info(cfg["result_dir"], np.full((4,), 0.25),
                       rng.standard_normal((4, 2)),
                       np.stack([np.eye(2) * 0.5] * 4))
    return cfg


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    cfg = tiny_celeba(tmp_path_factory.mktemp("served"))
    return (cfg, JaxEngine(cfg, serve_batch=4, buckets=(2,)),
            InferenceEngine(cfg, serve_batch=4, buckets=(2,), device="cpu"))


def _images(n, seed):
    return np.random.default_rng(seed).random((n, 128, 128, 3)).astype(
        np.float32)


def _close(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [3, 1, 9])  # padded bucket 4, bucket 2, chunks
def test_image_paths_match_jax(engines, n):
    _, jeng, teng = engines
    x = _images(n, seed=n)
    for path in ("encode", "reconstruct", "represent"):
        _close(getattr(teng, path)(x), getattr(jeng, path)(x))
    recon = teng.reconstruct(x)
    assert recon.shape == (n, 128, 128, 3)
    assert recon.min() >= 0.0 and recon.max() <= 1.0


def test_code_paths_match_jax(engines):
    cfg, jeng, teng = engines
    rng = np.random.default_rng(11)
    t = rng.standard_normal((5, 2)).astype(np.float32)
    z = rng.standard_normal((3, 8)).astype(np.float32)
    _close(teng.decode_representation(t), jeng.decode_representation(t))
    _close(teng.decode(z), jeng.decode(z))
    _close(teng.t_log_density(t), jeng.t_log_density(t))


def test_uint8_images_match_jax(engines):
    _, jeng, teng = engines
    x = (_images(2, seed=12) * 255).astype(np.uint8)
    _close(teng.encode(x), jeng.encode(x))


def test_buckets_padding_and_chunking(engines):
    _, jeng, teng = engines
    assert teng.buckets == jeng.buckets == [2, 4]
    assert [teng._bucket_for(n) for n in (1, 2, 3, 4, 5)] == [2, 2, 4, 4, 4]
    x = _images(9, seed=13)
    chunked = teng.reconstruct(x)
    parts = np.concatenate([teng.reconstruct(x[i:i + 4])
                            for i in range(0, 9, 4)])
    np.testing.assert_array_equal(chunked, parts)
    assert "reconstruct@b2" in teng.latency_ema
    assert "reconstruct@b4" in teng.latency_ema
    with pytest.raises(ValueError, match="empty batch"):
        teng.reconstruct(x[:0])
    with pytest.raises(ValueError, match="rows of shape"):
        teng.reconstruct(np.zeros((2, 64, 64, 3), np.float32))


def test_generate(engines):
    cfg, _, teng = engines
    imgs = teng.generate(6, seed=3)
    assert imgs.shape == (6, 128, 128, 3) and np.isfinite(imgs).all()
    assert imgs.min() >= 0.0 and imgs.max() <= 1.0
    np.testing.assert_array_equal(imgs, teng.generate(6, seed=3))
    assert not np.array_equal(imgs, teng.generate(6, seed=4))
    assert teng.generate(0).shape == (0, 128, 128, 3)
    assert teng.warmup() >= 0.0
    assert nc.fused_instnorm_style_lrelu.launches == 0  # never on CPU


def test_frozen_bn_matches_jax(engines, tmp_path):
    cfg = engines[0]
    rng = np.random.default_rng(14)
    stats = {f"BatchNormTrain_{i}": {
        "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "var": (0.5 + rng.random(c)).astype(np.float32)}
        for i, c in enumerate([4, 4, 8, 8, 16, 16])}
    path = save_bn_stats(str(tmp_path / "bn_stats.npz"), stats)
    jeng = JaxEngine(cfg, serve_batch=4, buckets=(), bn_stats_path=path)
    teng = InferenceEngine(cfg, serve_batch=4, buckets=(1,),
                           bn_stats_path=path, device="cpu")
    x = _images(3, seed=15)
    _close(teng.encode(x), jeng.encode(x))
    # frozen BN: a row's result does not depend on its bucket
    _close(teng.encode(x[:1]), tuple(a[:1] for a in teng.encode(x)))


def test_bf16_within_band_of_float32(engines):
    cfg = engines[0]
    f32 = engines[2]
    bf16 = InferenceEngine(cfg, serve_batch=4, buckets=(), dtype="bfloat16",
                           device="cpu")
    x = _images(3, seed=16)
    a, b = f32.reconstruct(x), bf16.reconstruct(x)
    assert b.dtype == np.float32 and np.isfinite(b).all()
    assert np.abs(a - b).mean() < 0.02


def test_engine_construction_errors(engines, tmp_path):
    cfg = engines[0]
    with pytest.raises(ValueError, match="mesh_devices"):
        InferenceEngine(cfg, serve_batch=4, device="cpu", mesh_devices=2)
    empty = dict(cfg, checkpoint_dir=str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="allow_uninitialized"):
        InferenceEngine(empty, serve_batch=4, device="cpu")
    eng = InferenceEngine(empty, serve_batch=4, device="cpu",
                          allow_uninitialized=True)
    assert eng.reconstruct(_images(1, 0)).shape == (1, 128, 128, 3)


def test_cuda_requested_without_a_card_raises(engines, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(engines[0], serve_batch=4)  # default device: cuda
    cfg_path = _write_config(engines[0], Path(engines[0]["result_dir"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--config", str(cfg_path), "--device", "cuda",
                     "--generate", "1"])


def _write_config(cfg, where):
    """A JSON config that process_config resolves to the tiny checkpoint."""
    raw = {k: v for k, v in cfg.items()
           if k not in ("summary_dir", "result_dir", "checkpoint_dir")}
    ck = Path(cfg["checkpoint_dir"])
    raw["load_dir"] = str(ck.parent)  # checkpoint_dir = load_dir/exp_name
    target = ck.parent / raw["exp_name"]
    if not target.exists():
        target.symlink_to(ck, target_is_directory=True)
    path = where / "cfg.json"
    path.write_text(json.dumps(raw))
    return path


def test_cli_reconstruct_round_trip(engines, tmp_path):
    cfg, _, teng = engines
    cfg_path = _write_config(cfg, tmp_path)
    x = _images(5, seed=17)
    np.savez(tmp_path / "in.npz", x=x)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "ladder_tpu_torch.serve", "--config",
         str(cfg_path), "--device", "cpu", "--serve-batch", "4",
         "--reconstruct", str(tmp_path / "in.npz"),
         "--out", str(tmp_path / "out.npz")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "wrote (5, 128, 128, 3) reconstructions" in proc.stdout
    with np.load(tmp_path / "out.npz") as z:
        # the CLI engine has the default buckets (1, 8): 5 rows run as one
        # padded batch of 4 + 1 in both engines
        np.testing.assert_allclose(z["x"], teng.reconstruct(x), **TOL)


def test_http_micro_batching_and_drain(engines):
    _, _, teng = engines
    front = Batcher(teng, max_wait_ms=20.0)
    server = tserve.make_http_server(front, 0)
    port = server.server_address[1]
    thread = threading.Thread(
        target=tserve.serve_http, args=(teng, front, server, True))
    thread.start()
    xs = [_images(1, seed=20 + i) for i in range(4)]

    def post(x):
        buf = io.BytesIO()
        np.save(buf, x)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/reconstruct", data=buf.getvalue())
        with urllib.request.urlopen(req, timeout=120) as r:
            return np.load(io.BytesIO(r.read()))

    try:
        with ThreadPoolExecutor(4) as pool:
            outs = list(pool.map(post, xs))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive()
    assert health["ok"] and health["device"] == "cpu"
    assert health["batching"]["requests"] == 4
    assert health["batching"]["batches"] < 4  # some requests coalesced
    for x, out in zip(xs, outs):
        assert out.shape == (1, 128, 128, 3)
        assert np.isfinite(out).all()
    with pytest.raises(RuntimeError, match="closed"):
        front.submit("reconstruct", xs[0])  # drained and closed
