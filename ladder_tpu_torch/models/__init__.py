"""The CelebA-128 outer VAE, the inner VAE and the LadderModel bundle."""
