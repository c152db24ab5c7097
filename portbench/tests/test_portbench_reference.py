"""The plain reference against ladder_tpu_torch's CPU path (the kernels'
plain versions) at a tiny width: one train step in each mode, from the
same weights, images, mixture and noise, and the engine's two serving
paths with frozen BatchNorm."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import seeded
from portbench.reference import ladder_celeba as ref
from portbench.tests.tiny import TINY, TINY_TRAIN

ROOT = Path(__file__).resolve().parents[2]
# biases that a normalisation over their channel follows: their gradient
# is zero but for rounding, which is large beside it (a sum of ~1e4 terms
# that cancel)
NORMALISED_BIASES = {f"encoder.Conv_{i}.bias" for i in range(6)} | {
    f"decoder.Conv_{i}.bias" for i in (1, 2, 4, 6)}


def _config(name, overrides):
    from ladder_tpu_torch.utils.config import apply_defaults

    cfg = json.loads((ROOT / f"portbench/configs/{name}.json").read_text())
    cfg = apply_defaults(dict(cfg["config"], **overrides))
    cfg["enable_plots"] = 0
    return cfg


@pytest.mark.parametrize("mode", [1, 2])
def test_one_train_step_matches_the_port(mode):
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.training.losses import draw_noise
    from ladder_tpu_torch.training.step import init_state, make_train_step

    cfg = _config("celeba128", dict(TINY_TRAIN, fused_train_step=mode))
    seed = 2 ** 31 + 5
    weights = seeded.weights(cfg, seed, "cpu")
    model = make_model(cfg)
    state = init_state(model, device="cpu")
    model.load_state_dict(weights, strict=True)
    imgs = seeded.images(8, seed, "t", "cpu")
    w, m, covs = seeded.mixture(cfg, seed, "cpu")
    gm = dict(weights=w, means=m, chols=torch.linalg.cholesky(covs))
    lrs = ref.lrs_at_epoch(cfg, cfg["sg_pretraining"] + 1)
    flags = {"use_sg_prior": False, "use_mask": False}
    calls = 4 if mode == 1 else 1
    gen = torch.Generator().manual_seed(7)
    noise = [draw_noise(cfg, 8, gen, "cpu") for _ in range(calls)]
    step = make_train_step(model)
    _, out = step(state, imgs, None, gm, flags, lrs, True, noise=noise)

    losses, first, after = ref.train_steps(
        cfg, weights, [imgs.permute(0, 3, 1, 2)], (w, m, gm["chols"]),
        torch.Generator().manual_seed(7), lrs, mode)
    assert float(out["ae"]["loss_ae"]) == pytest.approx(
        float(losses[0]["loss_ae"]), rel=1e-5)
    assert float(out["prior"]["loss_prior"]) == pytest.approx(
        float(losses[0]["loss_prior"]), rel=1e-5)
    moments = {k: mm for g in state["opt"].values()
               for k, mm in g["m"].items()}
    assert set(moments) == set(first)
    params = dict(model.named_parameters())
    for k, g in first.items():
        if k in NORMALISED_BIASES:
            continue
        # the optimiser's state holds the clipped gradient; float32 sums
        # that cancel leave ~1e-3 of a leaf's largest element (0.08%
        # measured on encoder leaves)
        mine = moments[k] / (1 - ref.ADAM_B1)
        assert float((mine - g.clamp(-1.0, 1.0)).abs().max()) <= \
            2e-3 * max(float(g.abs().max()), 1e-3), k
        # the first Adam step moves an element by about lr * sign(g):
        # compare where the sign is not rounding's
        sure = (g.abs() > 0.05).numpy()
        np.testing.assert_allclose(params[k].detach().numpy()[sure],
                                   after[k].numpy()[sure], atol=1e-6,
                                   err_msg=k)


def test_serving_paths_match_the_port(tmp_path):
    from ladder_tpu_torch.serving.engine import InferenceEngine

    cfg = _config("celeba128", TINY)
    cfg.update(checkpoint_dir=str(tmp_path / "ck"),
               result_dir=str(tmp_path / "res"))
    seed = 11
    stats = seeded.bn_stats(cfg, seed, "cpu")
    np.savez(tmp_path / "bn.npz", **{f"{n}/{leaf}": t.numpy()
                                     for n, (mu, var) in stats.items()
                                     for leaf, t in (("mean", mu),
                                                     ("var", var))})
    engine = InferenceEngine(cfg, allow_uninitialized=True,
                             bn_stats_path=str(tmp_path / "bn.npz"),
                             device="cpu")
    weights = seeded.weights(cfg, seed, "cpu")
    engine.model.load_state_dict(weights, strict=True)
    imgs = seeded.images(5, seed, "serve", "cpu")
    rec = engine.reconstruct(imgs.numpy())
    (want,) = ref.serve(weights, cfg, "reconstruct", imgs, stats)
    np.testing.assert_allclose(rec, want.numpy(), atol=1e-5)
    t_mean, t_std = engine.represent(imgs.numpy())
    want_mean, want_std = ref.serve(weights, cfg, "represent", imgs, stats)
    np.testing.assert_allclose(t_mean, want_mean.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t_std, want_std.numpy(), rtol=1e-4, atol=1e-5)
