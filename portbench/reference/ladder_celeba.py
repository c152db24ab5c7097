"""Plain PyTorch reference of LaDDer's CelebA-128 model with the 'ours'
prior: the outer VAE, the inner VAE, the ELBO with the Gaussian-mixture
hyper-prior, TF1 Adam with the elementwise clip, the two train-step modes
and the two serving paths the benchmark drives.

It follows the published model (lin-shuyu/ladder-latent-data-distribution-
modelling, codes/models.py and codes/base.py) as the repository's packages
state it, in NCHW, and is written from those formulas alone: it imports
nothing of the measured program and takes nothing the program made. Every
tensor it needs (weights, images, the mixture, the frozen BatchNorm
statistics, the noise) is made by the benchmark from the run's seed and
handed to both sides, or worked out here from those inputs.

Parameters live in one dict keyed by the names ``param_spec`` gives, which
are the program's state-dict names, so the benchmark can load the same
tensors into the program. Convolutions and matrix products go through
``Precision``: float32 (the reference itself) or, for the controls, with
their operands rounded to TF32 and accumulated in float32, which is what
TF32 does on the card.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.95, 1e-8
LEAKY = 0.2
BN_EPS = 1e-3
IN_EPS = 1e-6
GROUPS = {"ae": ("encoder", "decoder"), "sigma": ("sigma",),
          "prior": ("prior",), "inner_sigma": ("inner_sigma",)}
GROUP_ORDER = ("ae", "sigma", "prior", "inner_sigma")


def _round(t):
    """To TF32: round to nearest even on the 13 low mantissa bits."""
    bits = t.float().contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class _Operand(torch.autograd.Function):
    """Rounds a product's operand; its gradient passes through."""

    @staticmethod
    def forward(ctx, t):
        return _round(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _Result(torch.autograd.Function):
    """A product's result as it is; the gradient arriving at it, which the
    product's backward takes as an operand, is rounded."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g)


class Precision:
    """Rounding of the convolutions and matrix products, forward and
    backward: float32 (the reference) or tf32 (the control of float32 with
    TF32 off), where every product's operands are rounded and its sum is
    float32; activations stay float32.

    ``p(x)`` rounds a product's operand, ``p.out(y)`` the gradient that
    reaches a product's result."""

    def __init__(self, name="float32"):
        if name not in ("float32", "tf32"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def __call__(self, t):
        return t if self.name == "float32" else _Operand.apply(t)

    def out(self, t):
        return t if self.name == "float32" else _Result.apply(t)


F32 = Precision("float32")


@contextlib.contextmanager
def tf32_off():
    """The card's float32: TF32 off for convolutions and matrix products
    (restored after)."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


# ---- parameters ---------------------------------------------------------

def param_spec(cfg):
    """[(name, shape)] of every trainable tensor, in the program's
    state-dict names."""
    h, code = cfg["num_hidden_units"], cfg["code_size"]
    hi, rep = cfg["num_hidden_units_inner_VAE"], cfg["representation_size"]
    nl, k = cfg["n_layers_inner_VAE"], cfg["kernel_size"]
    spec = []

    def dense(name, i, o):
        spec.extend([(f"{name}.weight", (o, i)), (f"{name}.bias", (o,))])

    def conv(name, i, o, kk):
        spec.extend([(f"{name}.weight", (o, i, kk, kk)),
                     (f"{name}.bias", (o,))])

    widths = [h // 4, h // 4, h // 2, h // 2, h, h]
    cin, size = cfg["dim_input_channel"], cfg["dim_input_x"]
    for i, w in enumerate(widths):
        conv(f"encoder.Conv_{i}", cin, w, k)
        spec.extend([(f"encoder.BatchNormTrain_{i}.gamma", (w,)),
                     (f"encoder.BatchNormTrain_{i}.beta", (w,))])
        cin = w
        if i < 5:
            size = -(-size // 2)
    flat = h * (size - k + 1) ** 2
    dense("encoder.code_mean", flat, code)
    dense("encoder.code_std_dev", flat, code)
    dense("decoder.Dense_0", code, h)
    for i in range(8):
        dense(f"decoder.dlatent_{i}", h, h)
    conv("decoder.Conv_0", h, h, 1)
    for i in (1, 2, 3):
        conv(f"decoder.Conv_{i}", h, h, 3)
    conv("decoder.Conv_4", h, h // 2, 3)
    conv("decoder.Conv_5", h // 2, h // 2, 3)
    conv("decoder.Conv_6", h // 2, h // 4, 3)
    conv("decoder.Conv_7", h // 4, h // 4, 3)
    conv("decoder.Conv_8", h // 4, 3, 1)
    for i, c in enumerate((h, h, h // 2, h // 4)):
        dense(f"decoder.style_mod_{i}.style", h, 2 * c)
    spec.append(("sigma.sigma", ()))
    spec.append(("inner_sigma.inner_sigma", ()))
    for i in range(nl):
        dense(f"prior.inner_encoder.enc_{i}", code if i == 0 else hi, hi)
    dense("prior.inner_encoder.representation_mean", hi, rep)
    dense("prior.inner_encoder.representation_std_dev", hi, rep)
    for i in range(nl):
        dense(f"prior.inner_decoder.dec_{i}", rep if i == 0 else hi, hi)
    dense("prior.inner_decoder.decoded_code", hi, code)
    return spec


def group_names(spec):
    """{group: [parameter names]} in spec order."""
    out = {g: [] for g in GROUP_ORDER}
    for name, _ in spec:
        top = name.split(".", 1)[0]
        for g in GROUP_ORDER:
            if top in GROUPS[g]:
                out[g].append(name)
    return out


def lrs_at_epoch(cfg, epoch):
    """The learning rates of each group at a 1-indexed epoch: the
    CelebA staircase for ae (/1, /2, /5, /10 at 25/50/75, each leg a 0.99
    decay), 0.99 decay for sigma, 1.01 growth for the prior groups."""
    base = cfg["learning_rate_ae"]
    if epoch <= 25:
        ae = base * 0.99 ** (epoch - 1)
    elif epoch <= 50:
        ae = base / 2 * 0.99 ** (epoch - 25)
    elif epoch <= 75:
        ae = base / 5 * 0.99 ** (epoch - 50)
    else:
        ae = base / 10 * 0.99 ** (epoch - 75)
    return dict(ae=ae,
                sigma=cfg["learning_rate_sigma"] * 0.99 ** (epoch - 1),
                prior=cfg["learning_rate_prior"] * 1.01 ** (epoch - 1),
                inner_sigma=cfg["learning_rate_inner_sigma"]
                * 1.01 ** (epoch - 1))


# ---- layers ---------------------------------------------------------------

def _lrelu(x):
    return torch.where(x > 0, x, LEAKY * x)


def _linear(P, name, x, prec):
    return prec.out(F.linear(prec(x), prec(P[f"{name}.weight"]),
                             P[f"{name}.bias"]))


def _same_pads(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(P, name, x, prec, stride=1, same=True):
    w = P[f"{name}.weight"]
    k = w.shape[-1]
    if same and k > 1:
        ph = _same_pads(x.shape[2], k, stride)
        pw = _same_pads(x.shape[3], k, stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return prec.out(F.conv2d(prec(x), prec(w), P[f"{name}.bias"],
                             stride=stride))


def _resize_matrix(n_in, n_out, like):
    """TF1 legacy bilinear resize (align_corners=False, src = dst*in/out)
    as an [out, in] matrix with at most two taps a row."""
    src = np.arange(n_out, dtype=np.float64) * (n_in / n_out)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    frac = src - lo
    m = np.zeros((n_out, n_in), np.float64)
    m[np.arange(n_out), lo] += 1.0 - frac
    m[np.arange(n_out), hi] += frac
    return torch.tensor(m, dtype=torch.float32, device=like.device)


def _resize(x, oh, ow, prec):
    if x.shape[2] != oh:
        x = prec.out(torch.einsum("bchw,oh->bcow", prec(x),
                                  _resize_matrix(x.shape[2], oh, x)))
    if x.shape[3] != ow:
        x = prec.out(torch.einsum("bchw,pw->bchp", prec(x),
                                  _resize_matrix(x.shape[3], ow, x)))
    return x


def _batch_norm(P, i, x, stats):
    g = P[f"encoder.BatchNormTrain_{i}.gamma"]
    b = P[f"encoder.BatchNormTrain_{i}.beta"]
    if stats is None:
        mean = x.mean(dim=(0, 2, 3))
        var = (x - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
    else:
        mean, var = stats[f"BatchNormTrain_{i}"]
    y = (x - mean[None, :, None, None]) \
        * torch.rsqrt(var + BN_EPS)[None, :, None, None]
    return y * g[None, :, None, None] + b[None, :, None, None]


def _style(P, i, x, dlatent, prec):
    c = x.shape[1]
    s = _linear(P, f"decoder.style_mod_{i}.style", dlatent, prec)
    s = s.reshape(-1, 2, c)
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + IN_EPS)
    y = y * (s[:, 0, :, None, None] + 1.0) + s[:, 1, :, None, None]
    return _lrelu(y)


# ---- the networks -------------------------------------------------------

def encode(P, cfg, x, prec=F32, bn_stats=None):
    """Images [B,3,H,W] in [0,1] -> (code mean, code std). ``bn_stats``:
    {'BatchNormTrain_i': (mean, var)} freezes the BatchNorm (serving)."""
    for i in range(6):
        x = _conv(P, f"encoder.Conv_{i}", x, prec, stride=2 if i < 5 else 1,
                  same=i < 5)
        x = _lrelu(_batch_norm(P, i, x, bn_stats))
    x = x.reshape(x.shape[0], -1)
    mean = _linear(P, "encoder.code_mean", x, prec)
    std = torch.relu(_linear(P, "encoder.code_std_dev", x, prec))
    return mean, std + cfg["latent_variance_precision"]


def decode_trunk(P, z, prec=F32):
    """Codes -> the input of the decoder's last leaky_relu, [B,h/4,128,128]."""
    h = P["decoder.Dense_0.weight"].shape[0]
    encoded = _lrelu(_linear(P, "decoder.Dense_0", z, prec))
    d = encoded
    for i in range(8):
        d = _lrelu(_linear(P, f"decoder.dlatent_{i}", d, prec))

    def up_conv(name, x):
        return _conv(P, name, _resize(x, 2 * x.shape[2], 2 * x.shape[3],
                                      prec), prec)

    x = _conv(P, "decoder.Conv_0", encoded.reshape(-1, h, 1, 1), prec)
    x = _resize(x, 2, 2, prec)
    x = _style(P, 0, _conv(P, "decoder.Conv_1", x, prec), d, prec)
    x = _style(P, 1, _conv(P, "decoder.Conv_2", x, prec), d, prec)
    x = _resize(x, 8, 8, prec)
    x = _lrelu(_conv(P, "decoder.Conv_3", x, prec))
    x = _style(P, 2, up_conv("decoder.Conv_4", x), d, prec)
    x = _lrelu(up_conv("decoder.Conv_5", x))
    x = _style(P, 3, up_conv("decoder.Conv_6", x), d, prec)
    return up_conv("decoder.Conv_7", x)


def output_stage(P, u, prec=F32):
    """leaky_relu -> 1x1 conv to the three colour channels."""
    return _conv(P, "decoder.Conv_8", _lrelu(u), prec)


def inner_encode(P, cfg, z, prec=F32):
    x = z
    for i in range(cfg["n_layers_inner_VAE"]):
        x = _lrelu(_linear(P, f"prior.inner_encoder.enc_{i}", x,
                                    prec))
    mean = _linear(P, "prior.inner_encoder.representation_mean", x, prec)
    std = torch.relu(_linear(P, "prior.inner_encoder.representation_std_dev",
                             x, prec))
    return mean, std + cfg["latent_variance_precision"]


def inner_decode(P, cfg, t, prec=F32):
    x = t
    for i in range(cfg["n_layers_inner_VAE"]):
        x = _lrelu(_linear(P, f"prior.inner_decoder.dec_{i}", x,
                                    prec))
    return _linear(P, "prior.inner_decoder.decoded_code", x, prec)


def gmm_logpdf(x, weights, means, chols):
    """log p(x) under a full-covariance mixture; x [..., D]."""
    d = means.shape[-1]
    flat = x.reshape(-1, d)
    diff = (flat[None] - means[:, None, :]).transpose(1, 2)      # [K,D,N]
    y = torch.linalg.solve_triangular(chols, diff, upper=False)
    logdet = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    comp = -0.5 * y.square().sum(1) - logdet[:, None] - 0.5 * d * LOG_2PI
    logw = torch.where(weights > 0, torch.log(weights.clamp_min(1e-38)),
                       torch.full_like(weights, -math.inf))
    return torch.logsumexp(comp + logw[:, None], dim=0).reshape(x.shape[:-1])


def inner_sigma_value(P, cfg):
    s = P["inner_sigma.inner_sigma"].abs()
    if cfg["TRAIN_inner_sigma"] == 1:
        lb = s.new_tensor(cfg["inner_sigma_lb"])
        s = torch.minimum(torch.maximum(s, lb),
                          s.new_tensor(cfg["inner_sigma_ub"]))
    return s


def losses(P, cfg, images, gm, noise, prec=F32):
    """(loss_ae, loss_prior) of one batch in the recipe's steady phase
    (past the standard-gaussian pretraining, the code mask off).

    images: uint8 [B,3,H,W]; gm: (weights, means, chols); noise: eps_z
    [B, code], eps_t [B, rep], eps_mc [L, B, rep]."""
    x = images.float() * (1.0 / 255.0)
    code = cfg["code_size"]
    rs = cfg["representation_size"]
    mean, std = encode(P, cfg, x, prec)
    z = mean + std * noise["eps_z"]
    dec = output_stage(P, decode_trunk(P, z, prec), prec)
    diff = x - dec
    l1_sum = diff.abs().sum()
    entropy_z = (-0.5 * code * LOG_2PI - 0.5 * code
                 - torch.log(std).sum(dim=1)).mean()
    isig = inner_sigma_value(P, cfg)
    t_mean, t_std = inner_encode(P, cfg, z, prec)
    t = t_mean + t_std * noise["eps_t"]
    err = (z - inner_decode(P, cfg, t, prec)).square()
    code_lik = -(err / (2.0 * isig.square())).sum(dim=1).mean()
    rep_reg = -code * torch.log(isig) - 0.5 * code * LOG_2PI
    entropy_t = (-0.5 * rs * LOG_2PI - 0.5 * rs
                 - torch.log(t_std).sum(dim=1)).mean()
    samples = t_mean + t_std * noise["eps_mc"]
    ce_t = gmm_logpdf(samples, *gm).mean()
    elbo_prior = code_lik + rep_reg - entropy_t + ce_t
    b = x.shape[0]
    l1 = l1_sum / b
    sigma = torch.maximum(P["sigma.sigma"].abs(), l1_sum / x.numel())
    input_dim = cfg["dim_input_x"] * cfg["dim_input_y"] \
        * cfg["dim_input_channel"]
    elbo = (-l1 / sigma - input_dim * torch.log(2.0 * sigma) - entropy_z
            + elbo_prior)
    return -elbo, -elbo_prior


def draw_noise(cfg, batch, generator):
    """One loss evaluation's standard normals, in the order eps_z, eps_t,
    eps_mc, from the generator on its own device."""
    shapes = (("eps_z", (batch, cfg["code_size"])),
              ("eps_t", (batch, cfg["representation_size"])),
              ("eps_mc", (cfg["n_MC_samples"], batch,
                          cfg["representation_size"])))
    return {name: torch.randn(shape, generator=generator,
                              device=generator.device, dtype=torch.float32)
            for name, shape in shapes}


# ---- training -------------------------------------------------------------

def adam_(P, M, V, t, grads, names, lr):
    """TF1 Adam with the +-1 clip, bias correction folded into the step."""
    lr_t = lr * math.sqrt(1.0 - ADAM_B2 ** t) / (1.0 - ADAM_B1 ** t)
    with torch.no_grad():
        for k in names:
            g = grads[k].clamp(-1.0, 1.0)
            M[k] = ADAM_B1 * M[k] + (1.0 - ADAM_B1) * g
            V[k] = ADAM_B2 * V[k] + (1.0 - ADAM_B2) * g * g
            P[k] = (P[k] - lr_t * M[k] / (torch.sqrt(V[k]) + ADAM_EPS)
                    ).requires_grad_(True)


def train_steps(cfg, params, batches, gm, generator, lrs, mode, prec=F32):
    """``len(batches)`` train steps from ``params`` (not changed). Mode 1:
    sequential sub-steps (ae, sigma, prior, inner_sigma), each with fresh
    noise and the parameters the sub-step before wrote. Mode 2: one forward
    and backward of loss_ae for every group at one parameter point.

    Returns (losses [{'loss_ae', 'loss_prior'}] a step, the first gradient
    {name: tensor} each group's optimiser got at step 1, before its clip,
    the parameters after the steps)."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    names = group_names([(k, None) for k in params])
    M = {k: torch.zeros_like(v) for k, v in P.items()}
    V = {k: torch.zeros_like(v) for k, v in P.items()}
    count = dict.fromkeys(GROUP_ORDER, 0)
    record, first = [], {}

    def update(group, grads):
        count[group] += 1
        if len(record) == 0:
            first.update({k: grads[k].detach() for k in names[group]})
        adam_(P, M, V, count[group], grads, names[group], lrs[group])

    for images in batches:
        step = {}
        if mode == 1:
            for group in GROUP_ORDER:
                noise = draw_noise(cfg, images.shape[0], generator)
                loss_ae, loss_prior = losses(P, cfg, images, gm, noise, prec)
                if group == "ae":
                    step["loss_ae"] = loss_ae.detach()
                if group == "prior":
                    step["loss_prior"] = loss_prior.detach()
                loss = loss_ae if group in ("ae", "sigma") else loss_prior
                g = torch.autograd.grad(loss, [P[k] for k in names[group]])
                update(group, dict(zip(names[group], g)))
        else:
            noise = draw_noise(cfg, images.shape[0], generator)
            loss_ae, loss_prior = losses(P, cfg, images, gm, noise, prec)
            step = {"loss_ae": loss_ae.detach(),
                    "loss_prior": loss_prior.detach()}
            every = [k for g in GROUP_ORDER for k in names[g]]
            g = dict(zip(every, torch.autograd.grad(
                loss_ae, [P[k] for k in every])))
            for group in GROUP_ORDER:
                update(group, g)
        record.append(step)
    return record, first, {k: v.detach() for k, v in P.items()}


# ---- serving ------------------------------------------------------------

def serve(P, cfg, path, images, bn_stats, prec=F32):
    """A serving path on uint8 [N,H,W,C] images with frozen BatchNorm:
    'reconstruct' -> images [N,H,W,C] clipped to [0,1] (the decode of the
    code mean), 'represent' -> (t mean, t std) of the code mean."""
    x = (images.float() * (1.0 / 255.0)).permute(0, 3, 1, 2)
    mean, _ = encode(P, cfg, x, prec, bn_stats)
    if path == "represent":
        return inner_encode(P, cfg, mean, prec)
    if path == "reconstruct":
        dec = output_stage(P, decode_trunk(P, mean, prec), prec)
        return (dec.clamp(0.0, 1.0).permute(0, 2, 3, 1),)
    raise ValueError(path)
