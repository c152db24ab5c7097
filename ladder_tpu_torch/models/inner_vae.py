"""Inner VAE over the latent code z -> representation t (the LaDDer
hyper-prior network) plus the VampPrior pseudo-inputs.

The port of ``ladder_tpu/models/inner_vae.py``: encode(z) and decode(t) as
separate modules; the std head is relu + latent_variance_precision.
"""

from __future__ import annotations

import torch
from torch import nn

from ladder_tpu_torch.models.layers import Dense, get_activation


class InnerEncoder(nn.Module):
    """n_layers dense -> (t_mean, t_std)."""

    def __init__(self, code_size, num_hidden_units, representation_size,
                 n_layers=5, activation="leaky_relu",
                 latent_variance_precision=1e-3, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.n_layers = n_layers
        self.act = get_activation(activation)
        self.latent_variance_precision = latent_variance_precision
        for i in range(n_layers):
            setattr(self, f"enc_{i}",
                    Dense(code_size if i == 0 else num_hidden_units,
                          num_hidden_units, dtype=dtype))
        self.representation_mean = Dense(num_hidden_units, representation_size)
        self.representation_std_dev = Dense(num_hidden_units,
                                            representation_size)

    def forward(self, z):
        x = z if self.dtype is None else z.to(self.dtype)
        for i in range(self.n_layers):
            x = self.act(getattr(self, f"enc_{i}")(x))
        x = x.float()
        mean = self.representation_mean(x)
        std = torch.relu(self.representation_std_dev(x))
        return mean, std + self.latent_variance_precision


class InnerDecoder(nn.Module):
    """n_layers dense -> decoded code, plus the std head when
    train_decoded_z_std (TRAIN_decoded_z_std) is set; else None."""

    def __init__(self, representation_size, num_hidden_units, code_size,
                 n_layers=5, activation="leaky_relu",
                 train_decoded_z_std=False, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.n_layers = n_layers
        self.act = get_activation(activation)
        self.train_decoded_z_std = train_decoded_z_std
        heads = ("dec",) + (("dec_std",) if train_decoded_z_std else ())
        for head in heads:
            for i in range(n_layers):
                setattr(self, f"{head}_{i}",
                        Dense(representation_size if i == 0
                              else num_hidden_units, num_hidden_units,
                              dtype=dtype))
        self.decoded_code = Dense(num_hidden_units, code_size)
        if train_decoded_z_std:
            self.decoded_code_std = Dense(num_hidden_units, code_size)

    def _stack(self, t, head):
        x = t if self.dtype is None else t.to(self.dtype)
        for i in range(self.n_layers):
            x = self.act(getattr(self, f"{head}_{i}")(x))
        return x.float()

    def forward(self, t):
        decoded_code = self.decoded_code(self._stack(t, "dec"))
        if self.train_decoded_z_std:
            return decoded_code, self.decoded_code_std(
                self._stack(t, "dec_std"))
        return decoded_code, None


class VampPseudoInputs(nn.Module):
    """Trainable pseudo-inputs, stored [n_mixtures, H, W, C] as in flax."""

    def __init__(self, n_mixtures, dim_x, dim_y, dim_c):
        super().__init__()
        self.psedeu_input = nn.Parameter(
            torch.empty(n_mixtures, dim_x, dim_y, dim_c))

    def forward(self):
        return self.psedeu_input
