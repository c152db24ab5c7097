"""The port's FID core (ladder_tpu_torch/utils/fid.py) against
ladder_tpu/utils/fid.py on the CPU. Tolerances:
  * frechet_distance: rtol 1e-6, on a well-conditioned pair, on a singular
    pair (fewer samples than features, and a dead feature), and on the
    eps-offset branch;
  * resize_images_np: 1e-6 absolute;
  * encoder_feature_fn on the same weights: 1e-5 absolute;
  * compute_FID_score with those extractors: rtol 1e-5.
"""

import numpy as np
import pytest

from ladder_tpu.utils import fid as jfid
from ladder_tpu_torch.utils import fid as tfid
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)
from tests.test_torch_serving import tiny_celeba


def _stats(act):
    return act.mean(axis=0), np.cov(act, rowvar=False)


def _pair(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "well-conditioned":
        a = rng.standard_normal((500, 16))
        b = rng.standard_normal((500, 16)) @ (
            np.eye(16) + 0.3 * rng.standard_normal((16, 16))) + 0.4
    else:  # 10 samples of 16 features, the first feature constant
        a = rng.standard_normal((10, 16))
        b = 1.5 * rng.standard_normal((10, 16)) - 0.2
        a[:, 0] = b[:, 0] = 0.7
    return a, b


@pytest.mark.parametrize("kind", ["well-conditioned", "singular"])
def test_frechet_distance_is_ladder_tpus(kind):
    a, b = _pair(kind)
    want = jfid.frechet_distance(*_stats(a), *_stats(b))
    got = tfid.frechet_distance(*_stats(a), *_stats(b))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(tfid.fid_from_activations(a, b),
                               jfid.fid_from_activations(a, b), rtol=1e-6)
    assert tfid.frechet_distance(*_stats(a), *_stats(a)) == pytest.approx(
        0.0, abs=1e-6)


def test_frechet_distance_eps_branch_is_ladder_tpus(monkeypatch):
    """The retry with eps on the diagonals. scipy's sqrtm is finite on the
    product of two covariances, singular ones included (their product is
    diagonalisable with real eigenvalues), so both packages are made to
    take the branch: their first square root of the singular pair comes
    back non-finite, the retry is theirs."""
    from scipy import linalg

    sqrtm = linalg.sqrtm
    a, b = _pair("singular", seed=1)
    calls = {"jax": 0, "torch": 0}

    def jax_sqrtm(m):
        calls["jax"] += 1
        return np.full_like(m, np.nan) if calls["jax"] == 1 \
            else sqrtm(m)

    real = tfid._trace_sqrt_product

    def torch_trace(s1, s2):
        calls["torch"] += 1
        return float("nan") if calls["torch"] == 1 else real(s1, s2)

    monkeypatch.setattr(jfid.linalg, "sqrtm", jax_sqrtm)
    monkeypatch.setattr(tfid, "_trace_sqrt_product", torch_trace)
    want = jfid.frechet_distance(*_stats(a), *_stats(b))
    got = tfid.frechet_distance(*_stats(a), *_stats(b))
    assert calls == {"jax": 2, "torch": 2}
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_non_finite_covariances_take_the_eps_branch_and_stay_nan():
    s = np.eye(3)
    s[0, 1] = np.nan
    assert np.isnan(tfid.frechet_distance(np.zeros(3), s, np.zeros(3),
                                          np.eye(3)))


@pytest.mark.parametrize("shape", [(5, 28, 28, 1), (3, 128, 128, 3),
                                   (4, 28, 28)])
def test_resize_images_is_ladder_tpus(shape):
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    np.testing.assert_allclose(tfid.resize_images_np(x, 64),
                               jfid.resize_images_np(x, 64), rtol=0,
                               atol=1e-6)


def test_preprocessing_is_ladder_tpus():
    x = np.random.default_rng(3).random((4, 8, 8, 3)).astype(np.float32)
    for fn in ("preprocess_input_original", "preprocess_input_generated"):
        np.testing.assert_array_equal(getattr(tfid, fn)(x * 300 - 20),
                                      getattr(jfid, fn)(x * 300 - 20))


@pytest.fixture(scope="module")
def extractors(tmp_path_factory):
    cfg = tiny_celeba(tmp_path_factory.mktemp("fid"))
    return (jfid.encoder_feature_fn(cfg),
            tfid.encoder_feature_fn(cfg, device="cpu"), cfg)


def test_encoder_features_are_ladder_tpus(extractors):
    jfn, tfn, _ = extractors
    rng = np.random.default_rng(4)
    for shape in ((6, 128, 128, 3), (6, 64, 64, 3), (6, 64, 64)):
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        got, want = tfn(x), np.asarray(jfn(x))
        assert got.shape == want.shape == (6, 8)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_compute_fid_score_is_ladder_tpus(extractors, tmp_path):
    jfn, tfn, _ = extractors
    rng = np.random.default_rng(6)
    f1, f2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    np.savez(f1, sampled_images=rng.integers(0, 256, (24, 64, 64, 3)))
    np.savez(f2, sampled_images=rng.random((24, 64, 64, 3)) * 1.2 - 0.1)
    want = jfid.compute_FID_score(f1, f2, feature_fn=jfn)
    got = tfid.compute_FID_score(f1, f2, feature_fn=tfn)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("network, weights", [("inception", "InceptionV3"),
                                              ("VGG", "VGG16")])
def test_imagenet_extractors_name_the_missing_weights(tmp_path, network,
                                                      weights):
    with pytest.raises(RuntimeError, match=weights):
        tfid.compute_FID_score("a.npz", "b.npz", network=network)
    with pytest.raises(ValueError, match="unknown"):
        tfid.compute_FID_score("a.npz", "b.npz", network="other")
