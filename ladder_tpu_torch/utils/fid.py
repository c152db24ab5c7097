"""FID: the Frechet distance between two image sets' feature statistics
(the port of ``ladder_tpu/utils/fid.py``, the reference's standalone tool,
codes/utils.py:127-200).

The preprocessing (/255 or a clip to [0,1], then [-1,1]; the TF1 bilinear
resize to 64x64) follows the reference. The Frechet distance is closed
form in numpy: scipy is not a dependency of the port, so the trace of
(S1 S2)^{1/2} is the sum of the square roots of the eigenvalues of
S1^{1/2} S2 S1^{1/2}, a symmetric matrix with the same eigenvalues as
S1 S2 (``numpy.linalg.eigh``), where ``ladder_tpu`` takes scipy's
``sqrtm`` of S1 S2; both retry with eps on the diagonals when the square
root is not finite.

The feature extractor is an explicit ``feature_fn(images [N,H,W,C] float in
[-1,1]) -> [N,D]``: ``encoder_feature_fn`` gives the trained LaDDer
encoder's code mean on the model's device (a model-space FID). The
InceptionV3 and VGG16 extractors need ImageNet weights from outside the
repository, and ``compute_FID_score`` raises for them.
"""

from __future__ import annotations

import numpy as np
import torch

from ladder_tpu_torch.ops.image import resize_bilinear_tf1
from ladder_tpu_torch.utils.device import float32_exact, resolve_device


def preprocess_input_original(x):
    """utils.py:127-131: /255 then [-1,1]."""
    x = x / 255.0
    x = (x - 0.5) * 2.0
    return x


def preprocess_input_generated(x):
    """utils.py:134-138: clip [0,1] then [-1,1]."""
    x = np.clip(x, 0.0, 1.0)
    x = (x - 0.5) * 2.0
    return x


def _psd_sqrt(a):
    """The symmetric square root of a positive semi-definite matrix
    (eigenvalues below zero by rounding count as zero)."""
    w, v = np.linalg.eigh((a + a.T) * 0.5)
    return (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T


def _trace_sqrt_product(sigma1, sigma2):
    """Tr((S1 S2)^{1/2}): the real parts of the principal square roots of
    the eigenvalues of S1^{1/2} S2 S1^{1/2} (as scipy's sqrtm, whose
    complex result ``ladder_tpu`` takes the real part of); nan when an
    input is not finite."""
    if not (np.isfinite(sigma1).all() and np.isfinite(sigma2).all()):
        return float("nan")
    r = _psd_sqrt(sigma1)
    m = r @ sigma2 @ r
    ev = np.linalg.eigvalsh((m + m.T) * 0.5)
    return float(np.sum(np.sqrt(ev.astype(np.complex128)).real))


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 (S1 S2)^{1/2}): the Frechet distance
    between two Gaussians (what tf.contrib.gan.eval computed for the
    reference, utils.py:196-200)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    tr_covmean = _trace_sqrt_product(sigma1, sigma2)
    if not np.isfinite(tr_covmean):
        offset = np.eye(sigma1.shape[0]) * eps
        tr_covmean = _trace_sqrt_product(sigma1 + offset, sigma2 + offset)
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * tr_covmean)


def fid_from_activations(act1, act2):
    """FID from two activation sets [N,D]."""
    mu1, sigma1 = act1.mean(axis=0), np.cov(act1, rowvar=False)
    mu2, sigma2 = act2.mean(axis=0), np.cov(act2, rowvar=False)
    return frechet_distance(mu1, sigma1, mu2, sigma2)


def resize_images_np(images, size):
    """Bilinear resize of NHWC (or NHW) host images to size x size with
    TF1's legacy coordinates (ops/image.py), on the CPU in float32."""
    x = np.asarray(images, np.float32)
    t = torch.as_tensor(x if x.ndim == 4 else x[..., None])
    out = resize_bilinear_tf1(t.permute(0, 3, 1, 2), size, size)
    out = out.permute(0, 2, 3, 1).numpy()
    return out if x.ndim == 4 else out[..., 0]


def encoder_feature_fn(config, checkpoint_dir=None, device="cuda"):
    """The trained LaDDer encoder's code_mean head as the embedding (a
    model-space FID, not the ImageNet-Inception one; ``ladder_tpu``'s
    fid.py:162-208).

    Returns feature_fn(images [N,H,W,C] float in [-1,1]) -> [N, code_size]
    on the host. On ``device``, with TF32 off, the images are rescaled to
    [0,1], resized to the model's input size, averaged to gray or
    broadcast to colour to match its channels, and encoded in one batch
    (the CelebA encoder's BatchNorm uses the batch's statistics, as
    ``ladder_tpu``'s one jitted call does)."""
    from ladder_tpu_torch.models.builder import make_model
    from ladder_tpu_torch.utils.checkpoint import CheckpointManager

    device = resolve_device(device)
    cfg = dict(config)
    if checkpoint_dir is not None:
        cfg["checkpoint_dir"] = checkpoint_dir
    model = make_model(cfg)
    model.load_flax_params(CheckpointManager(cfg).load(model.flax_params(),
                                                       "VAE"))
    model.to(device).eval().requires_grad_(False)
    h, w = cfg["dim_input_x"], cfg["dim_input_y"]
    c = cfg["dim_input_channel"]

    def feature_fn(images):
        x = np.asarray(images, np.float32)
        if x.ndim == 3:
            x = x[..., None]
        with torch.no_grad(), float32_exact():
            x = torch.as_tensor(x).to(device)
            x = ((x + 1.0) * 0.5).permute(0, 3, 1, 2)    # [-1,1] -> [0,1]
            if x.shape[2] != h or x.shape[3] != w:
                x = resize_bilinear_tf1(x, h, w)
            if x.shape[1] != c and c == 1:        # grayscale model, RGB set
                x = x.mean(dim=1, keepdim=True)
            elif x.shape[1] != c:                 # RGB model, grayscale set
                x = x.expand(-1, c, -1, -1)
            return model.encode(x.contiguous())[0].cpu().numpy()

    return feature_fn


def compute_FID_score(data_file1, data_file2, feature_fn=None,
                      second_set="generated", key="sampled_images",
                      resize_to=64, feature_size=140,
                      network="inception", pooling="avg"):
    """The reference's entry (utils.py:141-200): load two npz image sets,
    preprocess, resize to resize_to, extract features with feature_fn,
    return the FID.

    feature_fn is required: network='inception' and network='VGG' (the
    reference's ImageNet extractors, which would resize to feature_size
    first for Inception) need pretrained weights that the repository does
    not hold, and raise."""
    if feature_fn is None:
        if network in ("inception", "VGG"):
            raise RuntimeError(
                f"network={network!r} needs the ImageNet-pretrained "
                f"{'InceptionV3' if network == 'inception' else 'VGG16'} "
                "weights, which are not in the repository and are not "
                "ported; pass feature_fn (for example encoder_feature_fn)")
        raise ValueError(f"unknown FID network: {network!r}")
    d1 = np.load(data_file1)[key].astype(np.float32)
    d2 = np.load(data_file2)[key].astype(np.float32)
    d1 = preprocess_input_original(d1)
    d2 = (preprocess_input_generated(d2) if second_set == "generated"
          else preprocess_input_original(d2))
    d1 = resize_images_np(d1, resize_to)
    d2 = resize_images_np(d2, resize_to)
    score = fid_from_activations(feature_fn(d1), feature_fn(d2))
    print("FID score between {} and {} is:\n{}".format(
        data_file1, data_file2, score))
    return score
