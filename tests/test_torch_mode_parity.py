"""python -m ladder_tpu_torch.mode_parity against
scripts/mode_parity_celeba.sh and scripts/mode_parity_combine.py: the
same JSON from the same records (the port's own record layout,
QUALITY_torch_celeba.json, varied per mode and seed), the same refusal with
two seeds, and sweep's quality arguments per (mode, seed) equal to the
shell script's, its order, skip-if-done and retries, without training."""

import importlib.util
import json
import re
import shlex
import subprocess
from pathlib import Path

import numpy as np
import pytest

from ladder_tpu_torch import mode_parity as port

ROOT = Path(__file__).resolve().parents[1]


def _jax_combine():
    spec = importlib.util.spec_from_file_location(
        "jax_mode_parity_combine", ROOT / "scripts" / "mode_parity_combine.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX = _jax_combine()


def _records(out, seeds=(0, 1, 2)):
    """m{mode}_s{seed}.json from the port's CelebA record, each key moved
    by a draw of its own (active_mixtures an int; one FID None in mode 1
    at seed 2, as a record without a fit has)."""
    base = json.loads((ROOT / "QUALITY_torch_celeba.json").read_text())
    rng = np.random.default_rng(7)
    out.mkdir(exist_ok=True)
    for seed in seeds:
        for mode in (1, 2):
            rec = dict(base, seed=seed, train_wall_s=float(
                rng.uniform(100, 900)))
            for key in port.KEYS:
                if key == "active_mixtures":
                    rec[key] = int(rng.integers(5, 20))
                else:
                    rec[key] = base[key] * float(rng.uniform(0.9, 1.1))
            if (mode, seed) == (1, 2):
                rec["encoder_fid_generated_vs_test"] = None
            (out / f"m{mode}_s{seed}.json").write_text(json.dumps(rec))


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=1e-12, abs=1e-12)
    else:
        assert a == b and type(a) is type(b)


def test_combine_writes_the_jax_scripts_json(tmp_path, capsys):
    _records(tmp_path / "sweep")
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    assert JAX.main([str(tmp_path / "sweep"), "--out", str(jax_out)]) == 0
    jax_text = capsys.readouterr().out
    assert port.main(["combine", str(tmp_path / "sweep"), "--out",
                      str(port_out), "--device", "cpu"]) == 0
    port_text = capsys.readouterr().out
    want = json.loads(jax_out.read_text())
    got = json.loads(port_out.read_text())
    _close(want, got)
    assert port_text == jax_text
    assert set(got["metrics"]) == set(port.KEYS)  # every key, signed gap
    for key, m in got["metrics"].items():
        assert m["mode2_minus_mode1_mean"] == pytest.approx(
            m["mode2"]["mean"] - m["mode1"]["mean"])
    assert got["recipe"]["exp_name"] == "celeba"
    assert got["overrides"] == {"synthetic_n_val": 512}
    assert len(got["train_wall_s"]["mode1"]) == 3
    assert len(got["metrics"]["encoder_fid_generated_vs_test"]["mode1"][
        "values"]) == 2


def test_combine_needs_three_seeds_alike(tmp_path):
    _records(tmp_path, seeds=(0, 1))
    with pytest.raises(AssertionError) as jax_err:
        JAX.main([str(tmp_path), "--out", str(tmp_path / "j.json")])
    with pytest.raises(AssertionError) as port_err:
        port.main(["combine", str(tmp_path), "--out",
                   str(tmp_path / "p.json"), "--device", "cpu"])
    assert str(port_err.value) == str(jax_err.value)


def _shell_argv(out, fused, seed):
    """The quality arguments of scripts/mode_parity_celeba.sh for one
    (mode, seed), its variables substituted."""
    text = (ROOT / "scripts" / "mode_parity_celeba.sh").read_text()
    cmd = re.search(r"scripts/quality_baseline\.py \\\n(.*?)\n\s*>",
                    text, re.S).group(1).replace("\\\n", " ").rstrip(" \\")
    tag = f"m{fused}_s{seed}"
    for name, value in (("$OUT", out), ("$tag", tag), ("$fused", fused),
                        ("$seed", seed)):
        cmd = cmd.replace(name, str(value))
    return shlex.split(cmd)


def _args(out, *extra):
    return port.parse_args(["sweep", str(out), "--device", "cpu", *extra])


@pytest.mark.parametrize("fused", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sweep_argv_is_the_shell_scripts(tmp_path, fused, seed):
    out = str(tmp_path)
    argv = port.quality_argv(out, fused, seed, _args(out))
    assert argv[:-2] == _shell_argv(out, fused, seed)
    assert argv[-2:] == ["--device", "cpu"]


def test_sweep_order_skip_and_retries(tmp_path, monkeypatch):
    """The shell script's order (seed outer, mode 2 before 1), a record
    that exists skipped, a failing attempt retried, every record run from
    the repository's root through python -m ladder_tpu_torch.quality."""
    (tmp_path / "m1_s1.json").write_text("{}")
    calls = []

    def fake_run(cmd, cwd, env, stdout, stderr, timeout):
        out = cmd[cmd.index("--out") + 1]
        tag = Path(out).stem
        calls.append(tag)
        assert cmd[1:3] == ["-m", "ladder_tpu_torch.quality"]
        assert cwd == str(ROOT) and str(ROOT) in env["PYTHONPATH"]
        if tag == "m2_s2" and calls.count(tag) == 1:
            return subprocess.CompletedProcess(cmd, 1)
        Path(out).write_text("{}")
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(port.subprocess, "run", fake_run)
    monkeypatch.setattr(port, "RETRY_WAIT", 0)
    assert port.sweep(_args(tmp_path)) == 0
    assert calls == ["m2_s0", "m1_s0", "m2_s1", "m2_s2", "m2_s2", "m1_s2"]
    assert (tmp_path / "m2_s2.log").is_file()

    def always_fails(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 3)

    monkeypatch.setattr(port.subprocess, "run", always_fails)
    assert port.sweep(_args(tmp_path / "again")) == 1


def test_sweep_with_one_attempt_keeps_the_failed_log(tmp_path, monkeypatch):
    """attempts=1 (chip_smoke's sweep): each record runs once, in order,
    never after a pause; a failure fails the sweep and its log stays the
    failed attempt's."""
    calls = []

    def fake_run(cmd, cwd, env, stdout, stderr, timeout):
        out = cmd[cmd.index("--out") + 1]
        calls.append(Path(out).stem)
        if Path(out).stem == "m1_s1":
            stdout.write("failed attempt\n")
            return subprocess.CompletedProcess(cmd, 1)
        Path(out).write_text("{}")
        return subprocess.CompletedProcess(cmd, 0)

    def no_sleep(seconds):
        raise AssertionError(f"slept {seconds} s")

    monkeypatch.setattr(port.subprocess, "run", fake_run)
    monkeypatch.setattr(port.time, "sleep", no_sleep)
    assert port.sweep(_args(tmp_path), attempts=1) == 1
    assert calls == [f"m{m}_s{s}" for s in (0, 1, 2) for m in (2, 1)]
    assert (tmp_path / "m1_s1.log").read_text() == "failed attempt\n"
    assert not (tmp_path / "m1_s1.json").exists()


def test_sweep_defaults_are_the_shell_scripts(tmp_path):
    args = _args(tmp_path)
    assert (args.epochs, args.n_train, port.RETRY_WAIT) == (12, 12800, 30)
    assert (port.SEEDS, port.MODES, port.FID_SAMPLES, port.TIMEOUT) == (
        (0, 1, 2), (2, 1), 512, 7200)
    assert json.loads(args.override) == {
        "sg_pretraining": 3, "accurate_fit": 3, "synthetic_n_val": 512}
    assert port.ATTEMPTS == 3



def test_sweep_writes_what_combine_reads(tmp_path, monkeypatch):
    """sweep's six records (each the port's CelebA record at its seed) are
    what combine needs: every key of KEYS with both modes at seeds 0 1 2,
    in the shell script's order."""
    base = json.loads((ROOT / "QUALITY_torch_celeba.json").read_text())

    def fake_run(cmd, cwd, env, stdout, stderr, timeout):
        out = cmd[cmd.index("--out") + 1]
        seed = int(cmd[cmd.index("--seed") + 1])
        Path(out).write_text(json.dumps(dict(base, seed=seed)))
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(port.subprocess, "run", fake_run)
    assert port.sweep(_args(tmp_path), attempts=1) == 0
    rec = port.combined(str(tmp_path))
    assert set(rec["metrics"]) == set(port.KEYS)
    for key, m in rec["metrics"].items():
        assert m["mode1"]["values"] == m["mode2"]["values"] == [base[key]] * 3
    assert rec["what"].endswith("seeds 0,1,2")
