"""python -m ladder_tpu_torch.verify_real_data against
scripts/verify_real_data.py on the same files: the dataset layouts
(MNIST npz and idx, CelebA TFRecords, missing and unreadable files, an
unknown exp_name) and hand-written {exp}-result.npz + GM_prior_info.npz
files, one passing and one for each failing check. Both must print the
same OK/FAIL lines and exit with the same code."""

import contextlib
import gzip
import importlib.util
import io
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

from ladder_tpu_torch import verify_real_data as port
from ladder_tpu_torch.data.tfrecord import write_image_tfrecords
from tests.conftest import make_config

ROOT = Path(__file__).resolve().parents[1]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_verify_real_data", ROOT / "scripts" / "verify_real_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX = _jax_script()


def _verdict(text):
    """The lines after the config's echo (the part the checks print)."""
    return text.split("Results will be saved at:\n", 1)[1].split(
        "\n", 1)[1].lstrip("\n")


def _run_both(argv, monkeypatch):
    """(text, code) of the JAX script's main and of the port's main."""
    out = []
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["verify_real_data.py"] + argv)
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as exc:
        JAX.main()
    out.append((buf.getvalue(), exc.value.code))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = port.main(argv + ["--device", "cpu"])
    out.append((buf.getvalue(), code))
    return out


def _same(argv, monkeypatch):
    (jtext, jcode), (ptext, pcode) = _run_both(argv, monkeypatch)
    assert _verdict(ptext) == _verdict(jtext)
    assert pcode == jcode
    return _verdict(ptext), pcode


def _config(tmp_path, **kw):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(make_config(**kw)))
    return str(path)


def _write_idx(path, arr, magic):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", magic))
        for n in arr.shape:
            f.write(struct.pack(">I", n))
        f.write(arr.tobytes())


def _mnist(tmp_path, layout, n_train):
    rng = np.random.default_rng(0)
    xtr = rng.integers(0, 256, (n_train, 28, 28), dtype=np.uint8)
    ytr = rng.integers(0, 10, n_train, dtype=np.uint8)
    xte, yte = xtr[:16], ytr[:16]
    data = tmp_path / "data"
    data.mkdir()
    if layout == "npz":
        np.savez(data / "mnist.npz", x_train=xtr, y_train=ytr, x_test=xte,
                 y_test=yte)
    elif layout == "idx":
        d = data / "fashion_mnist"
        d.mkdir()
        _write_idx(d / "train-images-idx3-ubyte.gz", xtr, 2051)
        _write_idx(d / "train-labels-idx1-ubyte.gz", ytr, 2049)
        _write_idx(d / "t10k-images-idx3-ubyte.gz", xte, 2051)
        _write_idx(d / "t10k-labels-idx1-ubyte.gz", yte, 2049)
    return str(data)


def _celeba(tmp_path, splits=("train", "val", "test"), broken=()):
    data = tmp_path / "celeba"
    data.mkdir()
    imgs = np.random.default_rng(1).integers(0, 256, (2, 128, 128, 3),
                                             dtype=np.uint8)
    for split in splits:
        path = data / f"celebA_{split}.tfrecords"
        if split in broken:
            path.write_bytes(b"\x07" * 40)
        else:
            write_image_tfrecords(str(path), imgs)
    return str(data) + "/"


CHECK_CASES = {
    # name: (exp, layout, expected code, a line the verdict holds)
    "mnist_npz": ("mnist_digit", "npz", 0, "OK: mnist_digit dataset"),
    "mnist_small_warns": ("mnist_digit", "npz_small", 0, "WARN:"),
    "fashion_idx": ("mnist_fashion", "idx", 0, "OK: mnist_fashion dataset"),
    "mnist_missing": ("mnist_digit", "none", 1, "FAIL: no digit MNIST"),
    "celeba": ("celeba", "tfrecords", 0, "OK: "),
    "celeba_missing_split": ("celeba", "no_test", 1, "FAIL: missing"),
    "celeba_unreadable": ("celeba", "broken_val", 1, "unreadable"),
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_matches_the_jax_script(case, tmp_path, monkeypatch):
    exp, layout, code, line = CHECK_CASES[case]
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LADDER_DATA_DIR", raising=False)
    if exp == "celeba":
        data = _celeba(tmp_path, **{
            "tfrecords": {}, "no_test": {"splits": ("train", "val")},
            "broken_val": {"broken": ("val",)}}[layout])
        cfg = _config(tmp_path, exp_name="celeba", data_path=data,
                      num_hidden_units=16, dim_input_x=128,
                      dim_input_y=128, dim_input_channel=3)
    else:
        data = _mnist(tmp_path, layout.split("_")[0],
                      100 if layout.endswith("small") else 10000)
        cfg = _config(tmp_path, exp_name=exp, data_dir=data)
    text, got = _same(["check", "--config", cfg], monkeypatch)
    assert got == code and line in text


def test_unknown_exp_name_is_refused_alike(tmp_path, monkeypatch):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dict(make_config(), exp_name="cifar")))
    monkeypatch.setattr(sys, "argv", ["verify_real_data.py", "check",
                                      "--config", str(cfg)])
    with pytest.raises(ValueError) as jax_err:
        JAX.main()
    with pytest.raises(ValueError) as port_err:
        port.main(["check", "--config", str(cfg), "--device", "cpu"])
    assert str(port_err.value) == str(jax_err.value)
    assert "unknown exp_name" in str(port_err.value)


def _result(n_iter=4, epochs=5, drop=0.5, sigma_end=0.05, rising=False,
            val_gap=0.1, nonfinite=False, short=False):
    """A {exp}-result.npz's curves: train_loss falling by ``drop`` from the
    first epoch to the last, sigma annealing to ``sigma_end``."""
    first, last = 1000.0, 1000.0 * (1 - drop)
    tl = np.repeat(np.linspace(first, last, epochs), n_iter)
    if short:
        tl = tl[:-1]
    sigma = np.linspace(0.5, sigma_end, epochs)
    if rising:
        sigma[2] = sigma[1] + 0.2
    if nonfinite:
        tl[3] = np.nan
    vl = np.linspace(first, last * (1 + val_gap), epochs)
    return dict(train_loss=tl, sigma=sigma, n_train_iter=np.asarray(n_iter),
                val_loss=vl)


COMPARE_CASES = {
    # name: (curves, active mixtures, exit code, the check that fails)
    "passes": ({}, 12, 0, None),
    "nonfinite": ({"nonfinite": True}, 12, 1, "curves_finite"),
    "wrong_length": ({"short": True}, 12, 1, "curve_lengths"),
    "small_drop": ({"drop": 0.05}, 12, 1, "train_loss_drop"),
    "sigma_too_high": ({"sigma_end": 0.3}, 12, 1, "final_sigma"),
    "sigma_rising": ({"rising": True}, 12, 1, "sigma_annealing"),
    "val_far_from_train": ({"val_gap": 2.0}, 12, 1, "val_tracks_train"),
    "too_few_mixtures": ({}, 2, 1, "active_mixtures"),
    "missing_gm_file": ({}, None, 1, "gm_prior_info"),
    "missing_result": (None, 12, 1, None),
}


@pytest.mark.parametrize("case", sorted(COMPARE_CASES))
def test_compare_matches_the_jax_script(case, tmp_path, monkeypatch):
    curves, n_active, code, failing = COMPARE_CASES[case]
    monkeypatch.chdir(tmp_path)
    cfg_path = _config(tmp_path, load_dir="pretrained")
    cfg = port._load_config(cfg_path)
    result_dir = Path(cfg["result_dir"])
    result_dir.mkdir(parents=True)
    if curves is not None:
        np.savez(result_dir / "mnist_digit-result.npz", **_result(**curves))
    if n_active is not None:
        w = np.full(50, 0.5 / 50)
        w[:n_active] = 0.5 / n_active + 0.01
        np.savez(result_dir / "GM_prior_info.npz", w_full=w,
                 w_active=w[:n_active])
    text, got = _same(["compare", "--config", cfg_path], monkeypatch)
    assert got == code
    if case == "passes":
        assert "All envelope checks passed" in text
    elif case == "missing_result":
        assert text.startswith("FAIL: no result file")
    else:
        assert f"FAIL {failing}:" in text and "FAILED checks" in text


def test_compare_finds_the_repositorys_envelopes():
    assert Path(port.ENVELOPES) == ROOT / "docs" / "envelopes"
    assert {p.stem for p in Path(port.ENVELOPES).glob("*.json")} == {
        "celeba", "mnist_digit", "mnist_fashion"}


def test_the_card_is_the_default_device(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.main(["compare", "--config", _config(tmp_path)])
