"""The port's quality record (ladder_tpu_torch/quality.py), its FID CLI
(eval_fid.py) and its seed spread (quality_spread.py) against the JAX
package's scripts, on the CPU at the tiny recipe of tests/test_scripts.py.

- The record has the JAX script's keys (read from its source), finite
  values and a self-floor under 1e-6.
- The JAX package's own functions applied to the port's artifacts give the
  port's record: ``ladder_tpu.utils.fid`` on the port's checkpoint and
  npz files within rtol 1e-5, the curve endpoints and the active mixtures
  exactly.
- ``check_against`` decides, and prints, as the JAX script's on a
  hypothesis table of records and baselines, with and without a seed
  spread.
- ``eval_fid``'s JSON line is the JAX CLI's (the FID within rtol 1e-5).
- ``quality_spread`` writes the JAX script's ``seed_spread`` from the same
  stub records, with no training.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ladder_tpu_torch import eval_fid, quality, quality_spread
from tests.test_torch_losses import few_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
TINY = {"sg_pretraining": 1, "accurate_fit": 1, "batch_size": 64,
        "n_mixtures": 4, "n_MC_samples": 4, "num_hidden_units": 64,
        "num_hidden_units_inner_VAE": 16, "n_layers_inner_VAE": 2}
FID_RTOL = 1e-5


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The tiny mnist_digit recipe through quality.main on the CPU, and a
    config file of the trained model for the FID CLIs."""
    tmp = tmp_path_factory.mktemp("quality")
    out, wd = tmp / "q.json", tmp / "wd"
    argv = ["--config", str(ROOT / "codes/mnist_digit_config.json"),
            "--out", str(out), "--workdir", str(wd), "--epochs", "2",
            "--n-train", "256", "--n-test", "128", "--fid-samples", "64",
            "--override", json.dumps(TINY), "--device", "cpu"]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        rc = quality.main(argv)
    finally:
        os.chdir(cwd)
    assert rc == 0
    cfg = json.loads((ROOT / "codes/mnist_digit_config.json").read_text())
    cfg.update(TINY)
    cfg_file = tmp / "tiny_config.json"
    cfg_file.write_text(json.dumps(cfg))
    record = json.loads(out.read_text())
    return dict(record=record, wd=wd, cfg_file=cfg_file, tmp=tmp)


def _jax_record_keys():
    """The keys of the JAX script's record: those of its dict literal in
    order, then the ones it assigns later."""
    tree = ast.parse((SCRIPTS / "quality_baseline.py").read_text())
    literal, later = [], []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "record"
                and isinstance(node.value, ast.Dict)):
            literal = [k.value for k in node.value.keys]
        elif (isinstance(node, ast.Assign)
              and isinstance(node.targets[0], ast.Subscript)
              and getattr(node.targets[0].value, "id", None) == "record"):
            later.append(node.targets[0].slice.value)
    return literal, set(literal) | set(later)


def test_record_has_the_jax_records_keys_and_finite_values(run):
    rec = run["record"]
    literal, keys = _jax_record_keys()
    assert len(literal) > 10
    assert list(rec)[:len(literal)] == literal
    assert set(rec) == keys
    assert rec["n_curve_points"] >= 2
    for key in quality_spread.SCALE_KEYS + ("sigma_start",):
        assert np.isfinite(rec[key]), (key, rec[key])
    assert rec["active_mixtures"] >= 1
    assert rec["overrides"]["n_mixtures"] == 4
    assert rec["recipe"]["n_mixtures"] == 4
    assert abs(rec["encoder_fid_self_floor"]) < 1e-6


def test_jax_functions_on_the_ports_artifacts_give_its_record(run):
    """ladder_tpu's encoder (loading the port's flax-bytes checkpoint) and
    FID on the port's npz files, and the JAX script's reading of the
    curves and the GM fit."""
    from ladder_tpu.ops.gmm import ACTIVE_WEIGHT_THRESHOLD
    from ladder_tpu.utils import fid as jfid
    from ladder_tpu.utils.config import process_config

    rec, wd = run["record"], run["wd"]
    cfg = process_config(str(run["cfg_file"]))
    fn = jfid.encoder_feature_fn(cfg, checkpoint_dir=str(wd / "ckpt") + "/")
    real, gen = str(wd / "real.npz"), str(wd / "generated.npz")
    fid = jfid.compute_FID_score(real, gen, feature_fn=fn, resize_to=28)
    floor = jfid.compute_FID_score(real, real, feature_fn=fn,
                                   second_set="original", resize_to=28)
    np.testing.assert_allclose(rec["encoder_fid_generated_vs_test"], fid,
                               rtol=FID_RTOL)
    assert abs(floor) < 1e-6 and abs(rec["encoder_fid_self_floor"]) < 1e-6

    res = np.load(wd / "result" / "mnist_digit-result.npz")
    assert rec["final_train_neg_elbo"] == float(res["train_loss"][-1])
    assert rec["final_val_neg_elbo"] == float(res["val_loss"][-1])
    assert rec["final_train_recons"] == float(res["recons_loss_train"][-1])
    assert rec["final_val_recons"] == float(res["recons_loss_val"][-1])
    assert rec["final_val_loss_prior"] == float(res["val_loss_prior"][-1])
    assert rec["final_train_code_elbo"] == float(res["code_elbo_train"][-1])
    assert rec["sigma_start"] == float(np.float64(res["sigma"][0]))
    assert rec["sigma_final"] == float(np.float64(res["sigma"][-1]))
    assert rec["n_curve_points"] == len(res["val_loss"])
    w = np.load(wd / "result" / "GM_prior_info.npz")["w_full"].ravel()
    assert rec["active_mixtures"] == int((w >= ACTIVE_WEIGHT_THRESHOLD).sum())
    assert rec["n_mixtures"] == w.size
    assert len(np.load(gen)["sampled_images"]) == rec["fid_samples"] == 64


# one table row: a baseline and a record, each metric present or None
_METRICS = ("final_train_neg_elbo", "final_val_neg_elbo",
            "final_train_recons", "final_val_recons", "sigma_final",
            "encoder_fid_generated_vs_test")


@st.composite
def _case(draw):
    base, rec = {}, {}
    for key in _METRICS:
        b = draw(st.one_of(st.none(), st.floats(-2000, 2000,
                                                allow_nan=False)))
        # near the tolerances: 0.5%, 5%, 2x spreads, the FID's 2.0
        rel = draw(st.sampled_from([0.0, 0.004, 0.006, 0.04, 0.06, 0.5,
                                    1.5, 2.5, -0.06, -1.0]))
        a = draw(st.one_of(
            st.none(),
            st.just(None if b is None else b * (1 + rel)),
            st.floats(-2000, 2000, allow_nan=False)))
        base[key], rec[key] = b, a
    base["active_mixtures"] = draw(st.one_of(st.none(),
                                             st.integers(0, 50)))
    rec["active_mixtures"] = draw(st.one_of(st.none(), st.integers(0, 50)))
    if draw(st.booleans()):
        rel = draw(st.dictionaries(st.sampled_from(_METRICS),
                                   st.floats(0, 0.2, allow_nan=False)))
        spread = {"rel": rel}
        if draw(st.booleans()):
            spread["active_mixtures_band"] = draw(st.integers(3, 20))
        base["seed_spread"] = spread
    return base, rec, draw(st.sampled_from([0.01, 0.05, 0.2]))


JAX_QUALITY = _script("quality_baseline")


@settings(max_examples=300, deadline=None)
@given(_case())
def test_check_against_decides_as_the_jax_script(case):
    base, rec, rtol = case
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "base.json")
        with open(path, "w") as f:
            json.dump(base, f)
        said = []
        for mod in (quality, JAX_QUALITY):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = mod.check_against(dict(rec), path, rtol)
            said.append((rc, buf.getvalue()))
    assert said[0] == said[1]


def test_check_against_on_the_anchor_itself():
    anchor = ROOT / "QUALITY_r04.json"
    rec = json.loads(anchor.read_text())
    assert quality.check_against(rec, str(anchor), 0.05) == 0
    worse = dict(rec, final_val_neg_elbo=-1141.0)
    assert quality.check_against(worse, str(anchor), 0.05) == 1
    # the FID's fallback tolerance (2.0 relative) never fails two
    # non-negative FIDs: the JAX check's quirk, kept
    far = dict(rec, encoder_fid_generated_vs_test=1e6)
    assert quality.check_against(far, str(anchor), 0.05) == 0
    assert JAX_QUALITY.check_against(far, str(anchor), 0.05) == 0


def test_out_never_defaults_to_a_jax_anchor(tmp_path):
    args = quality.parse_args([])
    assert not Path(args.out).name.startswith("QUALITY_r04")
    assert args.out == "QUALITY_torch.json" and args.device == "cuda"
    assert JAX_QUALITY.__doc__  # the JAX script's own default is the anchor
    for out in ("QUALITY_r04.json", "x/QUALITY_r04_celeba.json"):
        with pytest.raises(SystemExit):
            quality.parse_args(["--out", out])
    with pytest.raises(SystemExit):
        quality_spread.main(["--anchor", "QUALITY_r04_fashion.json"])


@pytest.mark.parametrize("second_set", ["generated", "original"])
def test_eval_fid_prints_the_jax_clis_line(run, second_set, capsys):
    wd = run["wd"]
    argv = [str(wd / "real.npz"), str(wd / "generated.npz"),
            "--network", "encoder", "--config", str(run["cfg_file"]),
            "--checkpoint-dir", str(wd / "ckpt") + "/",
            "--second-set", second_set, "--resize-to", "28"]
    lines = []
    for main, extra in ((eval_fid.main, ["--device", "cpu"]),
                        (_script("eval_fid").main, [])):
        assert main(argv + extra) == 0
        lines.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    got, want = lines
    np.testing.assert_allclose(got.pop("fid"), want.pop("fid"),
                               rtol=FID_RTOL)
    assert got == want
    if second_set == "generated":  # the record's own FID, the same files
        assert eval_fid.main(argv + ["--device", "cpu"]) == 0
        fid = json.loads(capsys.readouterr().out.splitlines()[-1])["fid"]
        np.testing.assert_allclose(
            fid, run["record"]["encoder_fid_generated_vs_test"], rtol=1e-6)


@pytest.mark.parametrize("network, weights", [("inception", "InceptionV3"),
                                              ("VGG", "VGG16")])
def test_eval_fid_names_the_missing_imagenet_weights(network, weights):
    with pytest.raises(RuntimeError, match=weights):
        eval_fid.main(["a.npz", "b.npz", "--network", network,
                       "--device", "cpu"])


def _stub_records():
    """Per-seed stand-ins of quality records (a missing FID, a missing
    count and negative values included)."""
    recs = {}
    for s in (0, 1, 2):
        rng = np.random.default_rng(s)
        recs[s] = {k: float(v) for k, v in zip(
            _METRICS, [-1420 + 9 * rng.standard_normal(),
                       -1426 + 7 * rng.standard_normal(),
                       22.4 + rng.standard_normal(),
                       22.4 + rng.standard_normal(),
                       0.028 * (1 + 0.05 * rng.standard_normal()),
                       0.009 * (1 + 0.3 * rng.standard_normal())])}
        recs[s]["active_mixtures"] = 20 + s * 3
        recs[s]["train_wall_s"] = 600.0 + s
    recs[2]["encoder_fid_generated_vs_test"] = None
    recs[1]["active_mixtures"] = None
    return recs


@pytest.mark.parametrize("seeds", [[0, 1], [0, 1, 2], [2]])
def test_quality_spread_writes_the_jax_scripts_seed_spread(
        tmp_path, monkeypatch, seeds):
    """Both scripts' mains with their training subprocess replaced by a
    stub that writes the seed's record to --out."""
    recs = _stub_records()
    seen = []

    def fake_run(cmd, check=True, **kw):
        seed = int(cmd[cmd.index("--seed") + 1])
        seen.append(cmd)
        with open(cmd[cmd.index("--out") + 1], "w") as f:
            json.dump(recs[seed], f)

    jax_spread = _script("quality_spread")
    anchors = []
    for name, mod in (("torch", quality_spread), ("jax", jax_spread)):
        anchor = tmp_path / f"QUALITY_{name}_stub.json"
        anchor.write_text(json.dumps({"final_val_neg_elbo": -1426.26}))
        monkeypatch.setattr(mod.subprocess, "run", fake_run)
        argv = ["--anchor", str(anchor), "--seeds"] + [str(s) for s in seeds]
        assert mod.main(argv + ["--extra", "--device", "cpu"]
                        if mod is quality_spread else argv) == 0
        anchors.append(json.loads(anchor.read_text()))
    assert anchors[0] == anchors[1]
    assert anchors[0]["final_val_neg_elbo"] == -1426.26
    torch_cmds = seen[:len(seeds)]
    assert all(c[1:3] == ["-m", "ladder_tpu_torch.quality"]
               and c[-2:] == ["--device", "cpu"] for c in torch_cmds)
    spread = quality_spread.seed_spread(recs, seeds)
    assert spread == anchors[0]["seed_spread"]
