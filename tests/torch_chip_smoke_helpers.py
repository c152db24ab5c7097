"""Helpers shared by the CPU rehearsals of chip_smoke.py's phases
(tests/test_torch_chip_smoke_<phase>.py)."""

import chip_smoke


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


# CelebA at h=16 from seeded groups (phases 7 and 8)
SMALL_CELEBA = dict(chip_smoke.INTERP_CELEBA_OVERRIDES, num_hidden_units=16,
                    code_size=16, representation_size=2,
                    num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
                    n_mixtures=3, n_MC_samples=2, batch_size=8,
                    synthetic_n_train=32, synthetic_n_val=16,
                    synthetic_n_test=8)
