"""The port's serving export (ladder_tpu_torch/serving/export.py) on a tiny
CelebA 'ours' checkpoint written by ladder_tpu (h=16, serve_batch 4), on
the CPU: every path's torch.export graph, loaded back, reproduces the live
engine bit for bit, normalises uint8 input as the engine does, agrees with
ladder_tpu's jax.export artifact of the same path on the same weights
within 1e-5 absolute, and the decoding graphs hold the norm-chain
operator; and the mnist_digit 'GMM' paths, which have no t-space."""

import numpy as np
import pytest
import torch

from ladder_tpu.serving import InferenceEngine as JaxEngine
from ladder_tpu.serving import export as jexport
from ladder_tpu_torch.serving import InferenceEngine
from ladder_tpu_torch.serving import export as texport
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)
from tests.test_torch_serving import tiny_celeba

ATOL = 1e-5
B = 4
PATHS = ("encode", "decode", "reconstruct", "represent",
         "decode_representation")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    cfg = tiny_celeba(root)
    eng = InferenceEngine(cfg, serve_batch=B, buckets=(2,), device="cpu")
    jeng = JaxEngine(cfg, serve_batch=B, buckets=(2,))
    return dict(cfg=cfg, eng=eng, jeng=jeng,
                paths=texport.export_inference(eng, str(root / "torch")),
                jpaths=jexport.export_inference(jeng, str(root / "jax")))


def _inputs(cfg, name, seed):
    rng = np.random.default_rng(seed)
    if name == "decode":
        return rng.standard_normal((B, cfg["code_size"])).astype(np.float32)
    if name == "decode_representation":
        return rng.standard_normal(
            (B, cfg["representation_size"])).astype(np.float32)
    return rng.random((B, 128, 128, 3)).astype(np.float32)


def _host(out):
    if isinstance(out, (tuple, list)):
        return tuple(_host(o) for o in out)
    return np.asarray(out.cpu() if torch.is_tensor(out) else out)


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def test_every_path_is_written(exported):
    assert sorted(exported["paths"]) == sorted(PATHS)
    assert all(p.endswith(f"{name}.pt2")
               for name, p in exported["paths"].items())


@pytest.mark.parametrize("name", PATHS)
def test_exported_path_reproduces_the_engine(exported, name):
    x = _inputs(exported["cfg"], name, 1)
    got = _tuple(_host(texport.load_exported(exported["paths"][name])(x)))
    want = _tuple(getattr(exported["eng"], name)(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", PATHS)
def test_exported_path_agrees_with_ladder_tpus(exported, name):
    x = _inputs(exported["cfg"], name, 2)
    got = _tuple(_host(texport.load_exported(exported["paths"][name])(x)))
    want = _tuple(_host(jexport.load_exported(exported["jpaths"][name])(x)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_uint8_input_is_normalised(exported):
    x = np.random.default_rng(3).integers(0, 256, (B, 128, 128, 3),
                                          dtype=np.uint8)
    call = texport.load_exported(exported["paths"]["reconstruct"])
    np.testing.assert_array_equal(_host(call(x)),
                                  exported["eng"].reconstruct(x))
    np.testing.assert_array_equal(
        _host(call(x)),
        _host(call(x.astype(np.float32) * np.float32(1.0 / 255.0))))


@pytest.mark.parametrize("name, holds", [
    ("decode", True), ("reconstruct", True), ("decode_representation", True),
    ("encode", False), ("represent", False)])
def test_decoding_graphs_hold_the_norm_chain_op(exported, name, holds):
    program = torch.export.load(exported["paths"][name])
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    ops = [t for t in targets if "norm_chain_fwd" in t]
    assert (len(ops) == 4) if holds else not ops
    if holds:
        assert all(t == "ladder_tpu_torch.norm_chain_fwd.default"
                   for t in ops)


def test_loaded_decode_runs_the_operator_and_counts_no_cpu_launch(exported):
    from ladder_tpu_torch.ops.norm_chain import fused_instnorm_style_lrelu

    before = fused_instnorm_style_lrelu.launches
    texport.load_exported(exported["paths"]["decode"])(
        _inputs(exported["cfg"], "decode", 4))
    assert fused_instnorm_style_lrelu.launches == before  # CPU: plain version


def test_a_multi_device_engine_and_unknown_paths_raise(exported, tmp_path):
    eng = exported["eng"]
    with pytest.raises(ValueError, match="not served"):
        texport.export_inference(eng, str(tmp_path), names=["generate"])
    eng.mesh = object()
    try:
        with pytest.raises(ValueError, match="single-device"):
            texport.export_inference(eng, str(tmp_path))
    finally:
        eng.mesh = None


def test_mnist_gmm_engine_exports_its_three_paths(tmp_path):
    from ladder_tpu_torch.models.builder import make_model
    from tests.conftest import make_config

    cfg = make_config(prior="GMM", num_hidden_units=64)
    cfg["checkpoint_dir"] = str(tmp_path / "ckpt") + "/"
    cfg["result_dir"] = str(tmp_path / "result") + "/"
    eng = InferenceEngine(cfg, serve_batch=B, buckets=(), device="cpu",
                          allow_uninitialized=True)
    eng.model.load_flax_params(make_model(cfg, seed=2).flax_params())
    paths = texport.export_inference(eng, str(tmp_path / "out"))
    assert sorted(paths) == ["decode", "encode", "reconstruct"]
    x = np.random.default_rng(5).random((B, 28, 28, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        _host(texport.load_exported(paths["reconstruct"])(x)),
        eng.reconstruct(x))


def test_serve_cli_exports(exported, tmp_path):
    from ladder_tpu_torch import serve as tserve
    from tests.test_torch_serving import _write_config

    cfg_path = _write_config(exported["cfg"], tmp_path)
    assert tserve.main(["--config", str(cfg_path), "--device", "cpu",
                        "--serve-batch", str(B), "--export",
                        str(tmp_path / "out")]) == 0
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == sorted(
        f"{name}.pt2" for name in PATHS)
    x = _inputs(exported["cfg"], "reconstruct", 6)
    np.testing.assert_array_equal(
        _host(texport.load_exported(str(tmp_path / "out" /
                                        "reconstruct.pt2"))(x)),
        exported["eng"].reconstruct(x))
