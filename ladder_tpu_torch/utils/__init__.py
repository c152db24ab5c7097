"""Config, flax-checkpoint reading and the flax <-> torch weight bridge."""
