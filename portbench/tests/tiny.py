"""The recipe's structure at widths a CPU test holds."""

TINY = {"num_hidden_units": 16, "code_size": 16,
        "num_hidden_units_inner_VAE": 16, "n_layers_inner_VAE": 2,
        "n_MC_samples": 4, "n_mixtures": 4}
TINY_TRAIN = dict(TINY, batch_size=8)
TRAIN_MIX = {"pool_images": 64, "side_images": 8}
SERVE_MIX = {"pool_images": 64, "check_requests": 8, "rate_rps": 20.0}
