"""The interpolation demo's helpers (the port of ``demo/demo_tools.py``):
the embedding of a validation image, the prior's log-density, the decode
of a path, and the four plot writers with the reference's PDF filenames.

The computing helpers run on the trainer's device and return numpy
arrays; the plot writers take those arrays and import matplotlib when
called, so the computation runs where matplotlib is absent.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ladder_tpu_torch.interp import embedding_dim, prior_logpdf_fn
from ladder_tpu_torch.utils.plotting import draw_ellipse, pyplot

# the density overlay's grid spacing (demo_tools.py:240)
GRID_STEP = 0.05


def val_images(idx, config, trainer):
    """The validation images the embedding is taken from: the mnist
    families' whole in-memory split; CelebA's batch-size window covering
    idx from the TFRecord split (the encoder's batch-statistic BatchNorm
    wants a batch of realistic size)."""
    if hasattr(trainer.data, "val_set"):
        return trainer.data.val_set["image"]
    n = max(int(config["batch_size"]), idx + 1)
    n = min(n, trainer.data.val.n)
    return trainer.data.val.reader.read_batch(np.arange(n))


def _host(t):
    return t.detach().cpu().numpy()


def embed_val_image(idx, config, trainer, x=None):
    """(embedding, panels) of validation image idx: the t-mean of a
    sampled code for 'ours'/'hierarchical', the code mean otherwise
    (demo_tools.py:41-75), and the triptych's images: the original, its
    decode from a sampled z and, with an inner VAE, from t."""
    if x is None:
        x = val_images(idx, config, trainer)
    fwd, gen = trainer.fwd, trainer.generator
    z = fwd["encode_sample"](x, gen)
    # the decoder works per image: decode only the row that is shown
    panels = {"original": np.asarray(x[idx]),
              "decoded": _host(fwd["decode"](z[idx:idx + 1])
                               .clamp(0, 1))[0]}
    if config["prior"] in ("ours", "hierarchical"):
        t_mean, _ = fwd["inner_encode"](z)
        embedding = t_mean
        z_from_t = fwd["inner_decode"](t_mean[idx:idx + 1])
        panels["from_t"] = _host(fwd["decode"](z_from_t).clamp(0, 1))[0]
    else:
        # the reference's 'decoded' panel uses the reparameterised sample;
        # the embedding is the posterior mean
        embedding, _ = fwd["encode"](x)
    return _host(embedding[idx]).reshape(-1), panels


def get_embeddings_from_val_set(idx, config, trainer, x=None,
                                save_plot=False):
    """The embedding of validation image idx (see embed_val_image); with
    save_plot, its triptych is written too."""
    embedding, panels = embed_val_image(idx, config, trainer, x)
    if save_plot:
        plot_triptych(panels, config, idx)
    return embedding


def define_prior_distribution(config, trainer):
    """log p(.) of the configured prior on the trainer's device
    (demo_tools.py:79-115): the trainer's fitted GM ('ours' over t, 'GMM'
    over z), the standard normal, or vampPrior's mixture of the encoded
    pseudo-inputs."""
    if config["prior"] == "vampPrior":
        pseudo = trainer.model.pseudo_inputs().permute(0, 2, 3, 1)
        mean, std = trainer.fwd["encode"](pseudo)
        return prior_logpdf_fn(config, vamp_params=(mean, std))
    gm = None
    if config["prior"] in ("ours", "GMM"):
        gm = trainer.gm_final or trainer.gm_fast
    return prior_logpdf_fn(config, gm=gm)


def decode_path(embeddings, config, trainer):
    """Images [n,H,W,C] in [0, 1] of a path's points: t -> z -> x with an
    inner VAE (its decoder's mean code), z -> x otherwise
    (demo_tools.py:163-212)."""
    emb = torch.as_tensor(np.asarray(embeddings, np.float32),
                          device=trainer.device)
    if config["prior"] in ("ours", "hierarchical"):
        emb = trainer.fwd["inner_decode"](emb)
    return _host(trainer.fwd["decode"](emb).clamp(0, 1))


def density_grid(log_prob, device, grid_size):
    """log p on the overlay's grid [-grid_size, grid_size)^2, spacing
    GRID_STEP (demo_tools.py:238-244), as an [n, n] array."""
    xs, ys = np.mgrid[-grid_size:grid_size:GRID_STEP,
                      -grid_size:grid_size:GRID_STEP]
    pos = np.dstack([xs, ys]).astype(np.float32).reshape(-1, 2)
    with torch.no_grad():
        logp = log_prob(torch.as_tensor(pos, device=device))
    return _host(logp).reshape(xs.shape)


def _name(config, kind, idx_start, idx_end, n_step, name_input=None):
    base = "{}{}-{}_{}_zdim_{}_nstep_{}".format(
        kind, idx_start, idx_end, config["prior"], embedding_dim(config),
        n_step)
    if name_input is not None:
        base += f"_{name_input}"
    return os.path.join(config["result_dir"], base + ".pdf")


def plot_triptych(panels, config, idx):
    """original_image_{idx}.pdf: the original, decoded from z and, with an
    inner VAE, decoded from t (demo_tools.py:41-78)."""
    plt = pyplot()
    names = [("original", "original"), ("decoded", "decoded from z")]
    if "from_t" in panels:
        names.append(("from_t", "decoded from t"))
    n = len(names)
    _, axs = plt.subplots(1, n, figsize=(2 * n, 2), edgecolor="k")
    for ax, (key, title) in zip(np.atleast_1d(axs).ravel(), names):
        ax.imshow(np.squeeze(panels[key]))
        ax.set_title(title)
        ax.grid(False)
        ax.set_xticks([])
        ax.set_yticks([])
    plt.savefig(os.path.join(config["result_dir"],
                             f"original_image_{idx}.pdf"))
    plt.close()


def plot_interpolation_losses(hist, n_iter, idx_start, idx_end, n_step,
                              config):
    """Four loss panels with the straight line's values as baselines
    (demo_tools.py:123-159)."""
    plt = pyplot()
    fig, axs = plt.subplots(1, 4, figsize=(15, 2.5), edgecolor="k")
    fig.subplots_adjust(hspace=0.2, wspace=0.4)
    panels = [(hist["obj"], "Overall loss", False),
              (hist["path_length"], "Path length", True),
              (hist["step_var"], "Step variance", True),
              (hist["neg_ll"], "Negative LL", True)]
    for ax, (series, title, baseline) in zip(axs.ravel(), panels):
        series = np.asarray(series)
        ax.plot(series, lw=2, label="SLP")
        if baseline:
            ax.axhline(y=series[0], color="r", ls="--", lw=2, label="SP")
            ax.legend()
        ax.set_title(title)
        ax.grid(True)
        ax.set_xlabel("Iteration")
        ax.set_xlim(0, n_iter)
    plt.savefig(_name(config, "loss_image", idx_start, idx_end, n_step))
    plt.close()


def plot_interpolated_images(images, config, n_step, idx_start, idx_end,
                             name_input=""):
    """The decoded strip, start to target (demo_tools.py:163-212)."""
    plt = pyplot()
    fig, axs = plt.subplots(1, n_step + 2, figsize=(2 * n_step, 2),
                            edgecolor="k")
    fig.subplots_adjust(hspace=0.0, wspace=0.0)
    axs = axs.ravel()
    axs[0].set_title("Start")
    axs[n_step + 1].set_title("Target")
    for i in range(n_step + 2):
        axs[i].imshow(np.squeeze(images[i]))
        axs[i].grid(False)
        axs[i].set_xticks([])
        axs[i].set_yticks([])
        if 1 <= i <= n_step:
            axs[i].set_title(f"Step {i}")
    plt.savefig(_name(config, "interpolated_image", idx_start, idx_end,
                      n_step, name_input))
    plt.close()


def plot_optimised_path(cur_pts, config, gm, embedding_start, embedding_end,
                        idx_start, idx_end, n_step, logp_grid=None,
                        plot_prior="density", w=2.0, grid_size=8.0,
                        name_input="", c="b"):
    """The 2-D path over the prior (demo_tools.py:216-288): the GM's
    ellipses ('circle'), or ``logp_grid`` from density_grid at the same
    grid_size ('density')."""
    plt = pyplot()
    fig, axs = plt.subplots(1, 1, figsize=(10, 10), edgecolor="k")
    if plot_prior == "circle" and gm is not None:
        w_, m_, K_ = (np.asarray(a) for a in gm)
        for i in range(len(w_)):
            draw_ellipse(m_[i], K_[i], w_[i] * w, ax=axs, color="k")
    elif plot_prior == "density" and logp_grid is not None:
        prior_pdf = np.exp(logp_grid) + 1e-8
        im = axs.imshow(np.log(prior_pdf), cmap="viridis", vmin=-14, vmax=0)
        # axes in latent coordinates, not pixel indices
        ticks = np.arange(0, grid_size // GRID_STEP * 2,
                          4 // GRID_STEP + 1)
        labels = list(np.arange(-grid_size, grid_size, 4))
        axs.set_xticks(ticks)
        axs.set_xticklabels(labels)
        axs.set_yticks(ticks)
        axs.set_yticklabels(labels)
        fig.colorbar(im)

    pts = np.asarray(cur_pts)
    pts_start = np.concatenate([embedding_start[None], pts], axis=0)
    pts_end = np.concatenate([pts, embedding_end[None]], axis=0)
    if plot_prior == "density":
        pts_start = (pts_start + grid_size) // GRID_STEP
        pts_end = (pts_end + grid_size) // GRID_STEP
    for i in range(n_step + 1):
        axs.plot([pts_start[i, 1], pts_end[i, 1]],
                 [pts_start[i, 0], pts_end[i, 0]], "-", color=c, lw=4,
                 zorder=1)
    axs.plot(pts_start[1:, 1], pts_start[1:, 0], ".", color=c, ms=15,
             zorder=50, label="Interpolation")
    axs.scatter(pts_start[0, 1], pts_start[0, 0], c="beige", s=80,
                label="Start", zorder=120)
    axs.scatter(pts_end[-1, 1], pts_end[-1, 0], c="orangered", s=80,
                label="Target", zorder=120)
    axs.legend()
    plt.title(f"interpolation method: {name_input}")
    plt.savefig(_name(config, "interpolated_path", idx_start, idx_end,
                      n_step, name_input))
    plt.close()
