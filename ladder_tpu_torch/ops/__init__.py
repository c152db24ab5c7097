"""Image ops, distributions, and the norm-chain kernel with its plain version."""
