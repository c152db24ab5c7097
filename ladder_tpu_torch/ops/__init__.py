"""Image ops, distributions, and the hand-written kernels (norm chain, output
stage, Adam) with their plain versions and their shared build helper."""
