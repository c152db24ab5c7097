"""Everything a run feeds the program and the reference, made from the
run's seed on the run's device: the weights, the synthetic CelebA-128
images, the Gaussian mixture of the hyper-prior, the frozen BatchNorm
statistics and the seeds of the program's own generators. The same seed
gives the same tensors; nothing is read from disk.
"""

from __future__ import annotations

import hashlib
import math

import torch

from portbench.reference.ladder_celeba import param_spec


def sub_seed(seed, tag):
    """A 63-bit seed for one purpose of a run, from the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed, tag, device):
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def weights(cfg, seed, device):
    """{name: float32 tensor} of every parameter, from one uniform draw:
    Xavier-uniform kernels, biases and BatchNorm offsets within +-0.05,
    BatchNorm scales within 1 +- 0.1, sigma and inner_sigma at the
    configuration's starting values."""
    spec = param_spec(cfg)
    total = sum(math.prod(shape) for _, shape in spec)
    u = torch.rand(total, generator=generator(seed, "weights", device),
                   device=device) * 2.0 - 1.0
    out, offset = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        x = u[offset:offset + n].reshape(shape)
        offset += n
        if name == "sigma.sigma":
            x = torch.full(shape, float(cfg["sigma"]), device=device)
        elif name == "inner_sigma.inner_sigma":
            x = torch.full(shape, float(cfg["inner_sigma"]), device=device)
        elif name.endswith(".weight"):
            fan_out = shape[0] * (math.prod(shape[2:]) if len(shape) > 2
                                  else 1)
            fan_in = math.prod(shape[1:])
            x = x * math.sqrt(6.0 / (fan_in + fan_out))
        elif name.endswith(".gamma"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.05 * x
        out[name] = x.contiguous()
    return out


def images(n, seed, tag, device, size=128, chunk=256):
    """Deterministic face-like images, uint8 [n, size, size, 3]: six smooth
    colour blobs an image (centres 0.2-0.8, widths 0.05-0.3, colours 0-1),
    summed and scaled to the image's maximum, as the repository's
    synthetic CelebA set is made, drawn here on the device."""
    g = generator(seed, f"images:{tag}", device)
    p = torch.rand((n, 6, 7), generator=g, device=device)
    lo = torch.tensor([0.2, 0.2, 0.05, 0.05, 0, 0, 0], device=device)
    hi = torch.tensor([0.8, 0.8, 0.3, 0.3, 1, 1, 1], device=device)
    p = lo + p * (hi - lo)
    grid = torch.arange(size, device=device, dtype=torch.float32) / size
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    for s in range(0, n, chunk):
        q = p[s:s + chunk]
        cx, cy, sx, sy = (q[..., i, None, None] for i in range(4))
        blob = torch.exp(-((grid[None, None, None, :] - cx) ** 2
                           / (2 * sx ** 2)
                           + (grid[None, None, :, None] - cy) ** 2
                           / (2 * sy ** 2)))                # [c,6,H,W]
        img = torch.einsum("cbhw,cbk->chwk", blob, q[..., 4:7])
        img = img / img.amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-6)
        out[s:s + chunk] = (img * 255).to(torch.uint8)
    return out


def mixture(cfg, seed, device):
    """(weights [K], means [K, D], covariances [K, D, D]) of the fitted
    hyper-prior the steps use: weights from a uniform draw, normalised;
    means within +-2; covariances A A^T + 0.05 I with A's entries within
    +-0.5."""
    k, d = cfg["n_mixtures"], cfg["representation_size"]
    g = generator(seed, "mixture", device)
    u = torch.rand(k + k * d + k * d * d, generator=g, device=device)
    w = 0.2 + u[:k]
    w = w / w.sum()
    means = (u[k:k + k * d].reshape(k, d) * 2 - 1) * 2.0
    a = (u[k + k * d:].reshape(k, d, d) * 2 - 1) * 0.5
    covs = a @ a.transpose(1, 2) + 0.05 * torch.eye(d, device=device)
    return w.contiguous(), means.contiguous(), covs.contiguous()


def bn_stats(cfg, seed, device):
    """Population statistics of the encoder's six BatchNorm layers:
    {'BatchNormTrain_i': (mean, var)}, means within +-0.5, variances
    0.5-1.5."""
    h = cfg["num_hidden_units"]
    widths = [h // 4, h // 4, h // 2, h // 2, h, h]
    u = torch.rand(2 * sum(widths), generator=generator(seed, "bn", device),
                   device=device)
    out, offset = {}, 0
    for i, c in enumerate(widths):
        mean = u[offset:offset + c] - 0.5
        var = 0.5 + u[offset + c:offset + 2 * c]
        offset += 2 * c
        out[f"BatchNormTrain_{i}"] = (mean.contiguous(), var.contiguous())
    return out
