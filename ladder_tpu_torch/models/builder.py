"""LadderModel: the outer VAE, inner VAE and prior modules for one dataset
as one ``nn.Module``.

The port of ``ladder_tpu/models/builder.py``. The submodules are the flax
parameter groups ('encoder', 'decoder', 'sigma', 'prior' holding the inner
VAE nets or the vamp pseudo-inputs, 'inner_sigma'), so the state-dict keys
are the flax paths joined with '.' (utils/weights.py). Images are NCHW
here; the serving engine converts from and to NHWC.

Only the CelebA family is ported so far; the mnist families raise.
"""

from __future__ import annotations

import torch
from torch import nn

from ladder_tpu_torch.models.celeba import CelebADecoder, CelebAEncoder
from ladder_tpu_torch.models.inner_vae import (
    InnerDecoder,
    InnerEncoder,
    VampPseudoInputs,
)
from ladder_tpu_torch.models.layers import init_parameters
from ladder_tpu_torch.utils.weights import flax_to_torch, torch_to_flax

PRIORS_WITH_INNER_VAE = ("ours", "hierarchical")
PRIORS_WITH_PRIOR_MODEL = ("ours", "hierarchical", "vampPrior")
PRIORS_WITH_GM = ("ours", "GMM")

COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16, None: None}


class LadderModel(nn.Module):
    """Parameters are float32; config['dtype'] = 'bfloat16' runs the conv and
    dense stacks in bf16 with fp32 heads and norm statistics."""

    def __init__(self, config, seed=0):
        super().__init__()
        cfg = self.config = config
        h = cfg["num_hidden_units"]
        exp = cfg["exp_name"]
        lvp = cfg["latent_variance_precision"]
        dt = self.dtype = COMPUTE_DTYPES[cfg.get("dtype", "float32")]
        if exp in ("mnist_digit", "mnist_fashion"):
            raise NotImplementedError(
                f"exp_name={exp!r} is not ported to ladder_tpu_torch yet; "
                "see ROADMAP.md for the order of the remaining modules")
        if exp != "celeba":
            raise ValueError(f"unknown exp_name: {exp}")
        self.encoder = CelebAEncoder(
            h, cfg["code_size"], cfg["kernel_size"], lvp, dtype=dt,
            bn_frozen=cfg.get("bn_mode") == "frozen",
            image_size=cfg["dim_input_x"],
            in_channels=cfg["dim_input_channel"])
        self.decoder = CelebADecoder(
            h, cfg["code_size"], dtype=dt,
            use_pallas=bool(cfg.get("use_pallas", 0)))
        self.sigma = nn.ParameterDict(
            {"sigma": nn.Parameter(torch.tensor(float(cfg["sigma"])))})
        self._bn_stats_set = False

        prior = {}
        if cfg["prior"] in PRIORS_WITH_INNER_VAE:
            hi, rep = cfg["num_hidden_units_inner_VAE"], cfg["representation_size"]
            n, act = cfg["n_layers_inner_VAE"], cfg["inner_activation"]
            prior["inner_encoder"] = InnerEncoder(
                cfg["code_size"], hi, rep, n, act, lvp, dtype=dt)
            prior["inner_decoder"] = InnerDecoder(
                rep, hi, cfg["code_size"], n, act,
                bool(cfg["TRAIN_decoded_z_std"]), dtype=dt)
            self.inner_sigma = nn.ParameterDict({"inner_sigma": nn.Parameter(
                torch.tensor(float(cfg["inner_sigma"])))})
        elif cfg["prior"] == "vampPrior":
            prior["vamp"] = VampPseudoInputs(
                cfg["n_mixtures"], cfg["dim_input_x"], cfg["dim_input_y"],
                cfg["dim_input_channel"])
        if prior:
            self.prior = nn.ModuleDict(prior)
        self.init_weights(seed)

    def init_weights(self, seed):
        """Random weights from a seeded generator (Xavier-uniform kernels,
        standard-normal pseudo-inputs)."""
        g = torch.Generator().manual_seed(seed)
        init_parameters(self, g)
        if "prior" in self._modules and "vamp" in self.prior:
            with torch.no_grad():
                self.prior["vamp"].psedeu_input.normal_(generator=g)

    # ---- flax-layout parameter trees ----------------------------------
    def flax_params(self):
        """The parameters as a flax-layout tree of numpy arrays."""
        return torch_to_flax(self.state_dict())

    def load_flax_params(self, tree):
        """Load a complete flax-layout tree (every key, matching shapes)."""
        state = {k: torch.tensor(v) for k, v in flax_to_torch(tree).items()}
        self.load_state_dict(state, strict=True)

    # ---- forward functions ---------------------------------------------
    def set_bn_stats(self, stats):
        """Population BN statistics for bn_mode='frozen':
        {'BatchNormTrain_i': {'mean': [c], 'var': [c]}} per encoder BN layer
        (serving/bn_freeze.load_bn_stats)."""
        for name, mv in stats.items():
            getattr(self.encoder, name).set_stats(mv["mean"], mv["var"])
        self._bn_stats_set = True

    def encode(self, x):
        """Images [B,C,H,W] in [0,1] -> (code_mean, code_std)."""
        if self.encoder.bn_frozen and not self._bn_stats_set:
            raise ValueError(
                "bn_mode='frozen' needs population statistics: call "
                "set_bn_stats() with serving.bn_freeze.load_bn_stats(...)")
        return self.encoder(x)

    def decode(self, z):
        """Codes [B, code_size] -> raw images [B,C,H,W] (float32)."""
        return self.decoder(z)

    def inner_encode(self, z):
        return self.prior["inner_encoder"](z)

    def inner_decode(self, t):
        return self.prior["inner_decoder"](t)

    def pseudo_inputs(self):
        """VampPrior pseudo-inputs as images [K,C,H,W]."""
        return self.prior["vamp"]().permute(0, 3, 1, 2)

    def sigma_value(self):
        """|sigma_var|; the pixel-error floor is applied in the loss."""
        return self.sigma["sigma"].abs()


def make_model(config, seed=0) -> LadderModel:
    return LadderModel(config, seed=seed)
