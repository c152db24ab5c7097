"""The port's interpolation demo (python -m ladder_tpu_torch.interpolate,
ladder_tpu_torch/demo_tools.py) on a tiny mnist_digit model made from
seeded weights and written as checkpoint groups: the CLI on the CPU writes
demo/interpolate.py's PDF filenames and prints its Final loss line; the
vampPrior log-density and the validation embeddings agree with
demo/demo_tools.py's and ladder_tpu's on the same weights (rtol = atol =
1e-5: float32 on both sides, the same formulas)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo import demo_tools as jdemo
from ladder_tpu.data.mnist import DataGenerator as JData
from ladder_tpu.models.builder import make_model as jmake
from ladder_tpu.training.trainer import MNISTTrainer as JTrainer
from ladder_tpu_torch import demo_tools, interpolate
from ladder_tpu_torch.data.mnist import DataGenerator
from ladder_tpu_torch.models.builder import make_model
from ladder_tpu_torch.training.trainer import MNISTTrainer
from ladder_tpu_torch.utils.checkpoint import VAE_KEYS, save_msgpack
from ladder_tpu_torch.utils.config import create_dirs, process_config
from tests.conftest import make_config
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(synthetic_n_train=256, synthetic_n_test=128, batch_size=64,
            num_hidden_units=64, num_hidden_units_inner_VAE=16,
            n_layers_inner_VAE=2, n_MC_samples=4, n_mixtures=4,
            num_epochs=0, load_model=1)


def tiny_demo(root, prior="ours", seed=2):
    """A config file whose load_dir holds a seeded model's checkpoint
    groups, laid out as pretrained_models/ is; returns its path."""
    cfg = make_config(prior=prior, load_dir=str(root / "models") + "/",
                      **TINY)
    params = make_model(cfg, seed=seed).flax_params()
    ckdir = root / "models" / cfg["exp_name"]
    ckdir.mkdir(parents=True)
    save_msgpack(str(ckdir / "vae-model.msgpack"),
                 {k: params[k] for k in VAE_KEYS})
    save_msgpack(str(ckdir / "prior-model.msgpack"),
                 {k: params[k] for k in ("prior", "inner_sigma")
                  if k in params})
    path = root / f"{prior}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def reference_pdf_names(cfg, idx_start, idx_end, n_step):
    """What demo/interpolate.py writes for this config: the two triptychs
    (demo_tools.py:77-78), the loss curves (:120-123), the SLP and SP
    strips (:157-160) and, for a 2-D t, the two path overlays
    (:217-222)."""
    dim = (cfg["representation_size"]
           if cfg["prior"] in ("ours", "hierarchical") else cfg["code_size"])
    tag = f"{idx_start}-{idx_end}_{cfg['prior']}_zdim_{dim}_nstep_{n_step}"
    names = [f"original_image_{idx_start}.pdf",
             f"original_image_{idx_end}.pdf", f"loss_image{tag}.pdf",
             f"interpolated_image{tag}_SLP.pdf",
             f"interpolated_image{tag}_SP.pdf"]
    if cfg["prior"] in ("ours", "hierarchical") and dim == 2:
        names += [f"interpolated_path{tag}_SLP.pdf",
                  f"interpolated_path{tag}_SP.pdf"]
    return sorted(names)


def test_cli_writes_the_reference_pdfs(tmp_path):
    config = tiny_demo(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "ladder_tpu_torch.interpolate", "--config",
         config, "--device", "cpu", "--n-iter", "50", "--idx-end", "5"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Outer VAE model loaded." in proc.stdout
    assert "Final fitted prior saved." in proc.stdout
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("Final loss: ")]
    assert len(line) == 1
    assert "; path length " in line[0] and "; neg-LL " in line[0]
    result = tmp_path / "figures" / "mnist_digit" / "result"
    cfg = json.loads(Path(config).read_text())
    pdfs = sorted(p.name for p in result.iterdir() if p.suffix == ".pdf")
    assert pdfs == reference_pdf_names(cfg, 0, 5, 8)
    assert (result / "GM_prior_info.npz").is_file()


def test_run_returns_the_arrays(tmp_path, monkeypatch):
    """run() on its own: the embeddings, the SLP and SP points, the
    history, the decoded strips in [0, 1] and the fit's record; the random
    init starts from draws of the fitted GM."""
    config = tiny_demo(tmp_path)
    monkeypatch.chdir(tmp_path)
    args = interpolate.get_args(["--config", config, "--n-iter", "20",
                                 "--n-step", "4", "--init", "random"])
    cfg = process_config(args.config)
    create_dirs([cfg["result_dir"]])
    res = interpolate.run(cfg, args, torch.device("cpu"))
    assert res["slp"].shape == res["sp"].shape == (4, 2)
    assert res["start"].shape == res["end"].shape == (2,)
    assert all(h.shape == (20,) and np.isfinite(h).all()
               for h in res["hist"].values())
    for strip in res["strips"].values():
        assert strip.shape == (6, 28, 28, 1)
        assert strip.min() >= 0 and strip.max() <= 1
    assert res["fit"]["mode"] == "accurate" and res["fit"]["samples"] == 256
    assert res["density"].shape == (280, 280)
    assert set(res["panels"]) == {0, 32}
    assert set(res["panels"][0]) == {"original", "decoded", "from_t"}


def test_main_refuses_to_start_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        interpolate.main(["--config", str(tmp_path / "none.json")])


def test_main_defaults_to_cuda(tmp_path):
    """Without --device cpu the demo asks for the card, and fails here."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interpolate.main(["--config", tiny_demo(tmp_path)])


def _both_trainers(prior, root):
    """A ladder_tpu trainer and a port trainer over the same weights."""
    cfg = make_config(prior=prior, enable_plots=0, **TINY)
    cfg["result_dir"] = str(root / "result") + "/"
    cfg["checkpoint_dir"] = str(root / "checkpoint") + "/"
    jmodel = jmake(cfg)
    params = jax.tree.map(jnp.asarray, make_model(cfg, seed=3).flax_params())
    jmodel.init = lambda rng: params
    return (cfg, JTrainer(jmodel, JData(cfg), cfg),
            MNISTTrainer(make_model(cfg, seed=3), DataGenerator(cfg), cfg,
                         device="cpu"))


def test_vamp_prior_log_density_matches_the_reference_demo(tmp_path):
    cfg, jt, tt = _both_trainers("vampPrior", tmp_path)
    x = np.random.default_rng(0).standard_normal(
        (9, cfg["code_size"])).astype(np.float32)
    want = jdemo.define_prior_distribution(cfg, jt)(jnp.asarray(x))
    got = demo_tools.define_prior_distribution(cfg, tt)(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("prior", ["ours", "vampPrior"])
def test_embedding_matches_ladder_tpu(tmp_path, prior):
    """'ours': the t-mean of the sampled z, against ladder_tpu's
    inner_encode of the same z; vampPrior: the code mean."""
    cfg, jt, tt = _both_trainers(prior, tmp_path)
    params = jt.state["params"]
    x = tt.data.val_set["image"]
    seen = []
    sample = tt.fwd["encode_sample"]
    tt.fwd["encode_sample"] = lambda x, g: seen.append(sample(x, g)) or \
        seen[-1]
    idx = 7
    got = demo_tools.get_embeddings_from_val_set(idx, cfg, tt)
    (z,) = seen
    if prior == "ours":
        want = jt.fwd["inner_encode"](params, jnp.asarray(z.numpy()))[0]
    else:
        want = jt.fwd["encode"](params, jnp.asarray(x))[0]
    assert got.shape == (want.shape[1],)
    np.testing.assert_allclose(got, np.asarray(want)[idx], **TOL)
