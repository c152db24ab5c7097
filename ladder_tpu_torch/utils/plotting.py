"""Per-epoch diagnostic plots (the port of ``ladder_tpu/utils/plotting.py``,
with its PDF filenames and layouts): reconstruction grids (the reference's
trainers.py:85-127, 211-248), GM prior scatter and density plots
(base.py:1012-1063), generated-sample grids (base.py:1124-1145) and
loss-curve panels (base.py:1170-1271), and the ellipse the interpolation
demo draws with.

matplotlib is imported inside the functions (``pyplot``): the package
imports torch, numpy and the standard library only, and the card's machine
has no matplotlib. The density plot's Gaussian densities are numpy's
(``gaussian_pdf``), in place of scipy's ``multivariate_normal``.
"""

from __future__ import annotations

import os

import numpy as np

from ladder_tpu_torch.ops.gmm import ACTIVE_WEIGHT_THRESHOLD


def pyplot():
    """matplotlib.pyplot on the Agg backend, or an ImportError that names
    matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def draw_ellipse(position, covariance, weight, ax=None, color="r"):
    """2-sigma ellipse of one mixture component (the reference's
    base.py:825-841)."""
    plt = pyplot()
    from matplotlib.patches import Ellipse

    ax = ax or plt.gca()
    covariance = np.asarray(covariance)
    if covariance.shape == (2, 2):
        U, s, _ = np.linalg.svd(covariance)
        angle = np.degrees(np.arctan2(U[1, 0], U[0, 0]))
        width, height = 2 * np.sqrt(s)
    else:
        angle = 0
        width, height = 2 * np.sqrt(covariance)
    nsig = 2
    ax.add_patch(Ellipse(np.asarray(position), nsig * width, nsig * height,
                         angle=angle, color=color, fill=False,
                         lw=weight * 10))


def gaussian_pdf(pos, mean, cov):
    """N(pos; mean, cov) for points pos [..., D] (float64): what
    ``scipy.stats.multivariate_normal(mean, cov).pdf(pos)`` gives for a
    positive-definite cov."""
    pos = np.asarray(pos, np.float64)
    mean = np.asarray(mean, np.float64)
    cov = np.asarray(cov, np.float64)
    d = mean.shape[-1]
    chol = np.linalg.cholesky(cov)
    diff = (pos - mean).reshape(-1, d)
    y = np.linalg.solve(chol, diff.T)                       # [D, N]
    maha = np.sum(y * y, axis=0).reshape(pos.shape[:-1])
    log_det = 2.0 * np.sum(np.log(np.diag(chol)))
    return np.exp(-0.5 * (maha + log_det + d * np.log(2.0 * np.pi)))


def plot_image_grid(images, filename, n=8, titles=None, narrow_space=True,
                    vmin=0.0, vmax=1.0):
    """n x n grid of images (trainers.py:85-110 layout)."""
    plt = pyplot()
    images = np.squeeze(np.asarray(images))
    fig, axs = plt.subplots(n, n, figsize=(12, 14), edgecolor="k")
    fig.subplots_adjust(hspace=0.0 if narrow_space else 0.4,
                        wspace=0.0 if narrow_space else 0.4)
    axs = axs.ravel()
    for i in range(n * n):
        axs[i].imshow(images[i], vmin=vmin, vmax=vmax)
        axs[i].grid(False)
        axs[i].set_xticks([])
        axs[i].set_yticks([])
        if titles is not None:
            axs[i].set_title(str(titles[i]))
    plt.savefig(filename)
    fig.clf()
    plt.close()


def plot_reconstructed_data(images, result_dir, cur_epoch, save_name=None,
                            title_attribs=None, narrow_space=True):
    """{save_name}_{epoch}_{j}.pdf for each whole 64 images."""
    images = np.squeeze(np.asarray(images))
    n_images = images.shape[0]
    for j in range(n_images // 64):
        name = save_name or "test_reconstructed"
        filename = os.path.join(result_dir, f"{name}_{cur_epoch}_{j}.pdf")
        plot_image_grid(images[64 * j:64 * (j + 1)], filename,
                        titles=None if title_attribs is None
                        else title_attribs[64 * j:64 * (j + 1)],
                        narrow_space=narrow_space)


def plot_ground_truth_test_set(images, result_dir, batch_size):
    """test_original_{j}.pdf for each whole 64 images of the batch."""
    images = np.squeeze(np.asarray(images))
    for j in range(batch_size // 64):
        filename = os.path.join(result_dir, f"test_original_{j}.pdf")
        plot_image_grid(images[64 * j:64 * (j + 1)], filename)


def plot_interleaved_recon(gt_images, images, result_dir, cur_epoch, idx_iter,
                           batch_size, save_name=None):
    """CelebA's alternating ground-truth and reconstruction rows
    (trainers.py:211-248)."""
    plt = pyplot()
    gt_images = np.asarray(gt_images)
    images = np.asarray(images)
    n_images = min(batch_size, 64)
    for j in range(batch_size // n_images):
        rows = (n_images // 8) * 2 if n_images // 8 <= 4 else 8
        fig, axs = plt.subplots(rows, 8, figsize=(16, 18), edgecolor="k")
        fig.subplots_adjust(hspace=0.0, wspace=0.0)
        axs = axs.ravel()
        for i in range(rows):
            for k in range(8):
                src = gt_images if i % 2 == 0 else images
                base = i * 8 // 2 if i % 2 == 0 else (i - 1) * 8 // 2
                axs[k + i * 8].imshow(
                    np.clip(src[k + base + n_images * j], 0, 1))
                axs[k + i * 8].grid(False)
                axs[k + i * 8].set_xticks([])
                axs[k + i * 8].set_yticks([])
        name = save_name or "test_reconstructed"
        plt.savefig(os.path.join(
            result_dir, f"{name}_{cur_epoch}_{idx_iter}_{j}.pdf"))
        fig.clf()
        plt.close()


def prior_density_grid(weights, means, covs, axis_scale=10,
                       active_threshold=ACTIVE_WEIGHT_THRESHOLD):
    """The density plot's image: the mean of the active components'
    densities over a 0.05 grid of [-axis_scale, axis_scale)^2, plus 1e-8
    (base.py:1040-1052)."""
    w, m, K = np.asarray(weights), np.asarray(means), np.asarray(covs)
    idx = [int(i) for i in np.where(w >= active_threshold)[0]]
    x, y = np.mgrid[-axis_scale:axis_scale:.05, -axis_scale:axis_scale:.05]
    pos = np.dstack([x, y])
    gm_pdf = np.zeros(x.shape)
    for i in idx:
        gm_pdf = gm_pdf + gaussian_pdf(pos, m[i], K[i])
    return gm_pdf / max(len(idx), 1) + 1e-8


def plot_prior_distribution(samples, weights, means, covs, result_dir,
                            cur_epoch, mode="crude-GM", style="circle",
                            axis_scale=10,
                            active_threshold=ACTIVE_WEIGHT_THRESHOLD):
    """2-D t-space scatter with ellipses, or the log-density image
    (base.py:1012-1063)."""
    plt = pyplot()
    samples = np.asarray(samples)
    w, m, K = np.asarray(weights), np.asarray(means), np.asarray(covs)
    idx = [int(i) for i in np.where(w >= active_threshold)[0]]
    fig, axs = plt.subplots(1, 1, figsize=(6, 6), edgecolor="k")
    if style == "circle":
        axs.scatter(samples[:, 0], samples[:, 1], s=1, c="b")
        for i in idx:
            draw_ellipse(m[i], K[i], weight=w[i])
        axs.set_xlim([-axis_scale, axis_scale])
        axs.set_ylim([-axis_scale, axis_scale])
        axs.set(aspect="equal")
        axs.set_title("Fitting a GMM to a batch of encodings")
        plt.savefig(os.path.join(
            result_dir, f"prior_estimate_circle_{cur_epoch}_{mode}.pdf"))
    elif style == "density":
        ticks = np.arange(0, axis_scale * 20 * 2, 40)
        labels = tuple(np.arange(-axis_scale, axis_scale, 2))
        gm_pdf = prior_density_grid(w, m, K, axis_scale, active_threshold)
        im = axs.imshow(np.log(gm_pdf), cmap="viridis", vmin=-12, vmax=0)
        axs.set_title("Estimate GM prior (log)")
        axs.set_xticks(ticks)
        axs.set_xticklabels(labels)
        axs.set_yticks(ticks)
        axs.set_yticklabels(labels)
        fig.colorbar(im)
        plt.savefig(os.path.join(
            result_dir, f"prior_estimate_density_{cur_epoch}_{mode}.pdf"))
    fig.clf()
    plt.close()


def plot_generated_samples(sampled_images, filename, n_sample=10, prior=""):
    """Grid of prior samples (base.py:1124-1145)."""
    plt = pyplot()
    sampled_images = np.squeeze(np.asarray(sampled_images))
    fig, axs = plt.subplots(n_sample, n_sample, figsize=(12, 12),
                            edgecolor="k")
    fig.subplots_adjust(hspace=0.0, wspace=0.0)
    axs = axs.ravel()
    for i in range(n_sample ** 2):
        axs[i].imshow(np.clip(sampled_images[i], 0, 1))
        axs[i].grid(False)
        axs[i].set_xticks([])
        axs[i].set_yticks([])
    plt.suptitle("Prior method: {}".format(prior))
    plt.savefig(filename)
    fig.clf()
    plt.close()


def _panels(axs, panels):
    for ax, (series, title) in zip(axs, panels):
        ax.plot(series, "b-")
        ax.set_xlim([0, max(len(series), 1)])
        ax.set_title(title)
        ax.grid(True)


def plot_train_and_val_loss_vae(rec, result_dir, train_sigma_flag,
                                sigma_init):
    """Outer-VAE loss panels (base.py:1172-1220)."""
    plt = pyplot()
    fig, axs = plt.subplots(1, 1, figsize=(8, 6), edgecolor="k")
    axs.plot(rec.train_loss, "b-")
    axs.plot(rec.iter_epochs_list, rec.val_loss_ave_epoch, "r-")
    axs.legend(("training loss (total)", "validation loss"))
    axs.set_title("Negative ELBO over iterations (val @ epochs)")
    axs.set_ylabel("total loss")
    axs.set_xlabel("iterations")
    axs.set_xlim([0, max(len(rec.train_loss), 1)])
    axs.grid(True)
    plt.savefig(os.path.join(result_dir, "loss-elbo.pdf"))
    plt.close()

    fig, axs = plt.subplots(1, 4, figsize=(14, 2), edgecolor="k")
    fig.subplots_adjust(hspace=0.4, wspace=0.4)
    _panels(axs.ravel(), [
        (rec.recons_error_val, "Reconstruction error"),
        (rec.entropy_z_val, "Entropy q(z|x)"),
        (rec.crossEntropy_prior_val, "Cross entropy q(z|x) || p(z)"),
        (rec.elbo_val, "ELBO"),
    ])
    plt.savefig(os.path.join(result_dir, "loss-outer-VAE-val.pdf"))
    plt.close()

    if train_sigma_flag == 1:
        plt.figure(num=1, figsize=(8, 6))
        plt.plot(rec.test_sigma, "b-")
        plt.title("scale parameter over training")
        plt.ylabel("sigma")
        plt.xlabel("epoch (zero index)")
        plt.ylim([0, sigma_init])
        plt.xlim([0, max(len(rec.test_sigma), 1)])
        plt.grid(True)
        plt.savefig(os.path.join(result_dir, "sigma.pdf"))
        plt.close()


def plot_train_and_val_loss_prior(rec, result_dir, prior):
    """Inner-VAE or vampPrior loss panels (base.py:1222-1271)."""
    plt = pyplot()
    if prior in ("ours", "hierarchical"):
        fig, axs = plt.subplots(2, 4, figsize=(16, 5), edgecolor="k")
        fig.subplots_adjust(hspace=0.4, wspace=0.4)
        axs = axs.ravel()
        _panels(axs, [
            (rec.code_recons_error_train, "Reconstruction error"),
            (rec.entropy_t_train, "Entropy q(t|z)"),
            (rec.crossEntropy_t_train, "Cross entropy q(t|z) || p(t)"),
            (rec.code_elbo_train, "ELBO"),
            (rec.code_recons_likelihood_train, "Reconstruction likelihood"),
            (rec.code_inner_sigma_train, "Inner VAE sigma"),
        ])
        axs[6].axis("off")
        axs[7].axis("off")
        plt.suptitle("Inner VAE losses")
        plt.savefig(os.path.join(result_dir, "loss-inner-VAE.pdf"))
        plt.close()
    else:
        fig, axs = plt.subplots(1, 2, figsize=(8, 2), edgecolor="k")
        fig.subplots_adjust(hspace=0.4, wspace=0.4)
        _panels(axs.ravel(), [
            (rec.train_loss_prior, "Prior loss"),
            (rec.vampPrior_crossEntropy_prior_train,
             "Cross entropy q(z|x) || p(z)"),
        ])
        plt.suptitle("VampPrior prior loss")
        plt.savefig(os.path.join(result_dir, "vampPrior-prior-loss.pdf"))
        plt.close()
