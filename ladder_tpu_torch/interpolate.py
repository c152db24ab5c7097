"""The latent-space SLP interpolation demo of the port:

    python -m ladder_tpu_torch.interpolate --config demo/mnist_digit_config.json \
        [--idx-start 0] [--idx-end 32] [--n-step 8] [--n-iter 500] \
        [--init linear|random] [--device cuda|cpu]

The counterpart of ``demo/interpolate.py``, with the same arguments plus
``--device`` (cuda unless the caller asks for the CPU; without a CUDA
device the default fails). It restores the trained model from the
config's checkpoint layout, fits the accurate GM ('ours' in t, 'GMM' in
z), embeds two validation images, optimises the shortest-likelihood path
between them (interp.py), prints the reference's ``Final loss`` line and
writes the SLP and SP image strips, the loss curves and, for a 2-D t, the
path over the prior's density into result_dir, under the reference's PDF
filenames. ``run`` does the computation and returns its arrays; the plots
need matplotlib, and ``main`` refuses to start without it.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ladder_tpu_torch.utils.device import float32_exact, resolve_device

# the path overlay's grid half-width (demo/interpolate.py:133)
OVERLAY_GRID = 7


def get_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-c", "--config", default="demo/mnist_digit_config.json")
    ap.add_argument("--idx-start", type=int, default=0)
    ap.add_argument("--idx-end", type=int, default=32)
    ap.add_argument("--n-step", type=int, default=8)
    ap.add_argument("--n-iter", type=int, default=500)
    ap.add_argument("--init", default="linear", choices=["linear", "random"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_trainer(config, device):
    """The dataset's data and trainer, as the train CLI dispatches on
    exp_name, restored from the config's checkpoints."""
    from ladder_tpu_torch.models.builder import make_model

    if config["exp_name"] == "celeba":
        from ladder_tpu_torch.data.celeba import CelebAData
        from ladder_tpu_torch.training.celeba_trainer import (
            CelebATrainer as Trainer,
        )
        data = CelebAData(config)
    else:
        from ladder_tpu_torch.data.mnist import DataGenerator
        from ladder_tpu_torch.training.trainer import MNISTTrainer as Trainer
        data = DataGenerator(config)
    model = make_model(config, seed=int(config.get("seed", 0)))
    trainer = Trainer(model, data, config, device=device)
    trainer.restore()
    return trainer


def prior_sample_fn(config, trainer):
    """Random-init interior points: draws from the fitted GM ('ours',
    'GMM'), standard normals in the embedding space otherwise."""
    import torch

    from ladder_tpu_torch.interp import embedding_dim
    from ladder_tpu_torch.ops.distributions import gmm_cholesky, sample_gmm

    def sample(generator, n):
        if config["prior"] in ("ours", "GMM"):
            w, m, K = trainer.gm_final or trainer.gm_fast
            return sample_gmm(generator, w, m, gmm_cholesky(K), n)
        return torch.randn((n, embedding_dim(config)), generator=generator,
                           device=generator.device)

    return sample


def run(config, args, device):
    """Everything the demo computes, on ``device``; returns a dict of the
    trainer, the fit's record, the embeddings, the triptych panels, the
    SLP and SP points, the history, the decoded strips, the overlay's
    density grid (2-D t only) and the SLP's seconds on the host clock."""
    import torch

    from ladder_tpu_torch.demo_tools import (
        decode_path,
        define_prior_distribution,
        density_grid,
        embed_val_image,
    )
    from ladder_tpu_torch.interp import interpolate

    # the demo trains nothing, so the trainer's plots never run
    # (demo/interpolate.py sets the same default)
    config.setdefault("enable_plots", 0)
    trainer = build_trainer(config, device)
    prior = config["prior"]
    fit = None
    if prior in ("ours", "GMM"):
        # the accurate fit over t ('ours') or z ('GMM'), notebook cell 14
        trainer.cur_epoch = max(trainer.cur_epoch, 1)
        trainer.timings.append({"epoch": trainer.cur_epoch, "gm": []})
        trainer.fit_GMM_VI(mode="accurate",
                           space="t" if prior == "ours" else "z")
        fit = trainer.timings[-1]["gm"][-1]

    print("Start sample:")
    start, start_panels = embed_val_image(args.idx_start, config, trainer)
    print("Target sample:")
    end, end_panels = embed_val_image(args.idx_end, config, trainer)
    log_prob = define_prior_distribution(config, trainer)

    t0 = time.perf_counter()
    with float32_exact():
        slp, sp, hist = interpolate(
            config, torch.as_tensor(start, device=trainer.device),
            torch.as_tensor(end, device=trainer.device), log_prob,
            n_step=args.n_step, n_iter=args.n_iter, init=args.init,
            generator=trainer.generator,
            sample_fn=prior_sample_fn(config, trainer))
    slp_seconds = time.perf_counter() - t0  # the history's copy synchronised
    print("Final loss: {:.4f}; path length {:.4f} (SP {:.4f}); "
          "neg-LL {:.4f} (SP {:.4f})".format(
              float(hist["obj"][-1]), float(hist["path_length"][-1]),
              float(hist["path_length"][0]), float(hist["neg_ll"][-1]),
              float(hist["neg_ll"][0])))

    slp, sp = slp.cpu().numpy(), sp.cpu().numpy()
    full = {"SLP": np.concatenate([start[None], slp, end[None]]),
            "SP": np.concatenate([start[None], sp, end[None]])}
    with float32_exact():
        strips = {name: decode_path(pts, config, trainer)
                  for name, pts in full.items()}
        density = None
        if (prior in ("ours", "hierarchical")
                and config["representation_size"] == 2):
            density = density_grid(log_prob, trainer.device, OVERLAY_GRID)
    return dict(trainer=trainer, fit=fit, log_prob=log_prob, start=start,
                end=end, panels={args.idx_start: start_panels,
                                 args.idx_end: end_panels},
                slp=slp, sp=sp, hist=hist, strips=strips, density=density,
                slp_seconds=slp_seconds)


def write_plots(result, config, args):
    """The demo's PDFs from run()'s arrays, under the reference's names."""
    from ladder_tpu_torch.demo_tools import (
        plot_interpolated_images,
        plot_interpolation_losses,
        plot_optimised_path,
        plot_triptych,
    )

    for idx, panels in result["panels"].items():
        plot_triptych(panels, config, idx)
    plot_interpolation_losses(result["hist"], args.n_iter, args.idx_start,
                              args.idx_end, args.n_step, config)
    print("SLP interpolation (ours)")
    plot_interpolated_images(result["strips"]["SLP"], config, args.n_step,
                             args.idx_start, args.idx_end, name_input="SLP")
    print("SP interpolation")
    plot_interpolated_images(result["strips"]["SP"], config, args.n_step,
                             args.idx_start, args.idx_end, name_input="SP")
    if result["density"] is not None:
        trainer = result["trainer"]
        gm = trainer.gm_final or trainer.gm_fast
        for pts, name in ((result["slp"], "SLP"), (result["sp"], "SP")):
            plot_optimised_path(
                pts, config, gm, result["start"], result["end"],
                args.idx_start, args.idx_end, args.n_step,
                logp_grid=result["density"], plot_prior="density",
                grid_size=OVERLAY_GRID, name_input=name)
    print("Demo artifacts written to {}".format(config["result_dir"]))


def main(argv=None):
    """Run the demo; returns run()'s dict."""
    from ladder_tpu_torch.utils.config import create_dirs, process_config
    from ladder_tpu_torch.utils.plotting import pyplot

    args = get_args(argv)
    pyplot()  # the plots come last: fail before the work if they cannot
    device = resolve_device(args.device)
    config = process_config(args.config)
    create_dirs([config["result_dir"]])
    result = run(config, args, device)
    write_plots(result, config, args)
    return result


if __name__ == "__main__":
    main()
