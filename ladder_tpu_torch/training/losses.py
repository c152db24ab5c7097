"""ELBO assembly for all five prior modes (the port of
``ladder_tpu/training/losses.py``).

Every term keeps ``ladder_tpu``'s formula, quirks included:

  * "entropy" terms are E_q[log q] (negative differential entropy);
  * the hierarchical entropy_t hardcodes dimension 2 whatever
    representation_size is;
  * the observation scale is floored by the batch's mean absolute pixel
    error, sigma = max(|sigma_var|, mean_pixel_error);
  * the 'ours' code-reconstruction mask zeroes the error where the
    posterior std exceeds 1, under flags['use_mask'];
  * code_l1_reconstruction_error = sum(sqrt(err)) feeds no loss (its
    gradient is infinite at err = 0);
  * MC cross-entropy terms draw L = n_MC_samples reparameterised samples
    and average log p_prior over them.

Images are NCHW here. For exp_name 'celeba' the reconstruction terms always
come from the fused output stage (ops/output_stage.py: the hand-written
kernels on CUDA tensors, their plain versions on CPU tensors);
``fused_output_stage`` in the config chooses nothing.

Noise: up to three standard-normal draws per call (``draw_noise``): eps_z
[B, code], eps_t [B, rep] ('ours'/'hierarchical') and eps_mc [L, B, D]
('ours': D = rep; 'GMM'/'vampPrior': D = code). ``compute_loss`` takes them
from ``noise`` or draws them from ``generator``, so tests can feed
``ladder_tpu`` and the port the same numbers.
"""

from __future__ import annotations

import torch

from ladder_tpu_torch.ops.distributions import (
    LOG_2PI,
    diag_mixture_logpdf,
    gmm_logpdf,
)
from ladder_tpu_torch.ops.output_stage import fused_output_recon


def draw_noise(config, batch_size, generator, device):
    """The standard-normal draws of one compute_loss call, float32 on
    ``device``, drawn in the order eps_z, eps_t, eps_mc."""
    prior = config["prior"]
    code, rep = config["code_size"], config["representation_size"]
    shapes = {"eps_z": (batch_size, code)}
    if prior in ("ours", "hierarchical"):
        shapes["eps_t"] = (batch_size, rep)
    if prior in ("ours", "GMM", "vampPrior"):
        shapes["eps_mc"] = (config["n_MC_samples"], batch_size,
                            rep if prior == "ours" else code)
    return {name: torch.randn(shape, generator=generator,
                              device=generator.device,
                              dtype=torch.float32).to(device)
            for name, shape in shapes.items()}


def compute_loss(model, x, generator=None, gm=None, flags=None, noise=None):
    """Full ELBO and metric set for one batch.

    x: images [B,C,H,W], float in [0,1] or uint8 (normalised here).
    gm: dict(weights [K], means [K,D], chols [K,D,D]), the fitted GM
        hyper-prior; required for 'ours'/'GMM', ignored otherwise.
    flags: dict(use_sg_prior, use_mask), bools or 0-dim bool tensors.
    Returns (loss_ae, metrics); metrics also holds loss_prior where the
    prior has one. The values stay attached to the autograd graph."""
    cfg = model.config
    prior = cfg["prior"]
    if x.dtype == torch.uint8:
        x = x.float() * (1.0 / 255.0)
    flags = flags or {}
    use_sg = torch.as_tensor(flags.get("use_sg_prior", False),
                             device=x.device)
    use_mask = torch.as_tensor(flags.get("use_mask", False), device=x.device)

    if noise is None:
        if generator is None:
            raise ValueError("compute_loss needs a generator or noise")
        noise = draw_noise(cfg, x.shape[0], generator, x.device)

    def sample(name, mean, std, leading=()):
        shape = tuple(leading) + tuple(mean.shape)
        eps = noise[name]
        if tuple(eps.shape) != shape:
            raise ValueError(f"noise[{name!r}] has shape {tuple(eps.shape)},"
                             f" expected {shape}")
        return mean + std * eps.to(device=mean.device, dtype=mean.dtype)

    code_mean, code_std = model.encode(x)
    z = sample("eps_z", code_mean, code_std)
    l1_sum = l2_sum = None
    if cfg["exp_name"] == "celeba":
        weight, bias = model.output_stage_params()
        decoded, l1_sum, l2_sum = fused_output_recon(
            model.decode_trunk(z), weight, bias, x)
    else:
        decoded = model.decode(z)
    code_size = cfg["code_size"]

    metrics = {}
    metrics["std_dev_code"] = code_std.mean(dim=0)

    # part I: E_q[log q(z|x)]
    entropy_z = (-0.5 * code_size * LOG_2PI - 0.5 * code_size
                 - torch.log(code_std).sum(dim=1)).mean()
    metrics["entropy_z"] = entropy_z

    # part II: cross-entropy against the standard gaussian
    ce_sg = (-0.5 * code_size * LOG_2PI
             - 0.5 * (code_mean.square().sum(dim=1)
                      + code_std.square().sum(dim=1))).mean()
    metrics["crossEntropy_prior_sg"] = ce_sg

    loss_prior = None
    L = cfg["n_MC_samples"]

    if prior == "standard_gaussian":
        crossEntropy_prior = ce_sg

    elif prior in ("ours", "hierarchical"):
        inner_sigma = model.inner_sigma_value()
        t_mean, t_std = model.inner_encode(z)
        t = sample("eps_t", t_mean, t_std)
        decoded_code, decoded_code_std = model.inner_decode(t)
        metrics["std_dev_representation"] = t_std.mean(dim=0)
        metrics["inner_sigma"] = inner_sigma
        metrics["representation_mean"] = t_mean
        metrics["representation_sample"] = t
        metrics["mean_code_error"] = (decoded_code - z).abs().mean()

        recons_error = (z - decoded_code).square()
        if prior == "ours":
            masked = torch.where(code_std > 1.0, 0.0, recons_error)
            code_recons_error = torch.where(use_mask, masked, recons_error)
        else:
            code_recons_error = recons_error
        code_recon_lik = -(code_recons_error
                           / (2.0 * inner_sigma.square())).sum(dim=1).mean()
        code_l1 = torch.sqrt(code_recons_error).sum(dim=1).mean()
        metrics["code_reconstruction_likelihood"] = code_recon_lik
        metrics["code_l1_reconstruction_error"] = code_l1

        representation_regularisor = (-code_size * torch.log(inner_sigma)
                                      - 0.5 * code_size * LOG_2PI)
        metrics["representation_regularisor"] = representation_regularisor

        rs = cfg["representation_size"]
        if prior == "ours":
            entropy_t = (-0.5 * rs * LOG_2PI - 0.5 * rs
                         - torch.log(t_std).sum(dim=1)).mean()
            samples = sample("eps_mc", t_mean, t_std, leading=(L,))
            ce_t = gmm_logpdf(samples, gm["weights"], gm["means"],
                              gm["chols"]).mean()
        else:
            # hierarchical: dimension 2 is hardcoded in entropy_t, kept
            # literally for parity
            entropy_t = (-0.5 * 2.0 * LOG_2PI - 0.5 * 2.0
                         - torch.log(t_std).sum(dim=1)).mean()
            ce_t = (-0.5 * rs * LOG_2PI
                    - 0.5 * (t_mean.square().sum(dim=1)
                             + t_std.square().sum(dim=1))).mean()
        metrics["entropy_t"] = entropy_t
        metrics["crossEntropy_representation"] = ce_t

        elbo_prior = (code_recon_lik + representation_regularisor
                      - entropy_t + ce_t)
        metrics["elbo_prior"] = elbo_prior
        crossEntropy_prior = torch.where(use_sg, ce_sg, elbo_prior)
        loss_prior = -elbo_prior

        if decoded_code_std is not None:
            # Gaussian NLL of z under N(decoded_code, exp(head)^2), the head
            # read as log-std; neither z nor decoded_code takes a gradient
            log_std = decoded_code_std
            nll = (log_std + 0.5 * ((z.detach() - decoded_code.detach())
                                    * torch.exp(-log_std)).square()
                   ).sum(dim=1)
            metrics["decoded_z_std_loss"] = nll.mean()

    elif prior == "GMM":
        samples = sample("eps_mc", code_mean, code_std, leading=(L,))
        crossEntropy_prior = gmm_logpdf(samples, gm["weights"], gm["means"],
                                        gm["chols"]).mean()

    elif prior == "vampPrior":
        pseudo_mean, pseudo_std = model.encode(model.pseudo_inputs())
        metrics["code_mean_prior"] = pseudo_mean
        metrics["code_std_dev_prior"] = pseudo_std
        samples = sample("eps_mc", code_mean, code_std, leading=(L,))
        weights = torch.full((cfg["n_mixtures"],), 1.0 / cfg["n_mixtures"],
                             device=x.device)
        ce_vamp = diag_mixture_logpdf(samples, weights, pseudo_mean,
                                      pseudo_std).mean()
        crossEntropy_prior = torch.where(use_sg, ce_sg, ce_vamp)

    else:
        raise ValueError(f"unknown prior: {prior}")

    metrics["crossEntropy_prior"] = crossEntropy_prior

    # reconstruction terms
    bsz = x.shape[0]
    if l1_sum is not None:
        # sums over all elements from the fused output stage, scaled per
        # batch and per element here
        metrics["l2_reconstruction_error"] = l2_sum / bsz
        l1 = l1_sum / bsz
        mean_pixel_error = l1_sum / x.numel()
    else:
        diff = x - decoded
        metrics["l2_reconstruction_error"] = diff.square().sum(
            dim=(1, 2, 3)).mean()
        l1 = diff.abs().sum(dim=(1, 2, 3)).mean()
        mean_pixel_error = diff.abs().mean()
    metrics["l1_reconstruction_error"] = l1
    metrics["mean_pixel_error"] = mean_pixel_error
    sigma = model.sigma_value()
    if cfg["TRAIN_sigma"] == 1 or cfg["exp_name"] == "celeba":
        # celeba floors unconditionally
        sigma = torch.maximum(sigma, mean_pixel_error)
    metrics["sigma"] = sigma

    reconstruction_likelihood = -l1 / sigma
    metrics["reconstruction_likelihood"] = reconstruction_likelihood

    input_dim = (cfg["dim_input_x"] * cfg["dim_input_y"]
                 * cfg["dim_input_channel"])
    sigma_regularisor = -input_dim * torch.log(2.0 * sigma)
    metrics["sigma_regularisor"] = sigma_regularisor

    elbo = (reconstruction_likelihood + sigma_regularisor
            - entropy_z + crossEntropy_prior)
    metrics["elbo"] = elbo
    loss_ae = -elbo
    metrics["loss_ae"] = loss_ae
    metrics["decoded"] = decoded
    metrics["code_mean"] = code_mean
    metrics["code_std_dev"] = code_std
    metrics["code_sample"] = z

    if prior == "vampPrior":
        loss_prior = loss_ae
    if loss_prior is not None:
        metrics["loss_prior"] = loss_prior

    return loss_ae, metrics


def identity_gm(n_mixtures, n_dims, dtype=torch.float32, device="cpu"):
    """Uniform-weight standard-normal mixture, used while pretraining and as
    the GMM prior's first-epoch feed."""
    return dict(
        weights=torch.full((n_mixtures,), 1.0 / n_mixtures, dtype=dtype,
                           device=device),
        means=torch.zeros((n_mixtures, n_dims), dtype=dtype, device=device),
        chols=torch.eye(n_dims, dtype=dtype, device=device).expand(
            n_mixtures, n_dims, n_dims).contiguous(),
    )
