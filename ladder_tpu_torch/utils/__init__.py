"""Config, device selection, flax-checkpoint reading and the flax <-> torch
weight and train-state bridge."""
