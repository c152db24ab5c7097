"""The port's committed quality records (QUALITY_torch_*.json): each
``seed_spread`` entry is what ``quality_spread.seed_spread`` computes from
the entry's own per-seed records, each record passes ``check_against``
against itself, and the fixed-data CelebA record is the seed-0 record on
the seed-0 synthetic set read through ``--data-dir``.

Then the CPU pair of ROADMAP.md §C (QUALITY_cpu_narrow_celeba_{jax,torch}
.json): both packages' records of one narrow CelebA-128 recipe on one fixed
data set, four seeds each, made by ``scripts/quality_baseline.py`` and by
``python -m ladder_tpu_torch.quality --device cpu``. The rule is applied
both ways: every seed of one package against the other's record. A fault
would show as a key that fails at every seed of one package on the same
side. ``python tests/test_torch_quality_records.py`` prints the table."""

import contextlib
import io
import json
import math
from pathlib import Path

import pytest

from ladder_tpu_torch.quality import check_against
from ladder_tpu_torch.quality_spread import SCALE_KEYS, seed_spread

ROOT = Path(__file__).resolve().parents[1]
RECORDS = sorted(ROOT.glob("QUALITY_torch_*.json"))
# the records whose seed spread was measured on the card, seeds 0-2
SPREAD = ("QUALITY_torch_celeba.json", "QUALITY_torch_celeba_fixed_data.json",
          "QUALITY_torch_celeba_tf32_fixed_data.json",
          "QUALITY_torch_mnist_digit.json")


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_the_spread_records_are_committed():
    names = [p.name for p in RECORDS]
    for name in SPREAD:
        assert name in names
        assert _load(ROOT / name)["seed_spread"]["seeds"] == [0, 1, 2]


@pytest.mark.parametrize("name", SPREAD)
def test_seed_spread_is_recomputed_from_its_records(name):
    entry = _load(ROOT / name)["seed_spread"]
    seeds = entry["seeds"]
    records = {s: entry["records"][str(s)] for s in seeds}
    assert seed_spread(records, seeds) == entry
    assert set(entry["rel"]) == set(SCALE_KEYS)


@pytest.mark.parametrize("path", RECORDS, ids=lambda p: p.name)
def test_a_record_passes_against_itself(path, capsys):
    assert check_against(_load(path), str(path), 0.05) == 0
    assert "ok" in capsys.readouterr().out


def test_fixed_data_record_is_its_spreads_seed_0():
    """The fixed-data record's own endpoints are seed 0's of its spread
    (the other two records keep their earlier seed-0 run's endpoints)."""
    rec = _load(ROOT / "QUALITY_torch_celeba_fixed_data.json")
    assert rec["seed"] == 0
    seed0 = rec["seed_spread"]["records"]["0"]
    for key in SCALE_KEYS + ("active_mixtures",):
        assert rec[key] == seed0[key]


def test_fixed_data_record_reads_the_seed_0_set():
    rec = _load(ROOT / "QUALITY_torch_celeba_fixed_data.json")
    assert rec["data"] == {"kind": "real", "dir": "/tmp/celeba_s0/",
                           "n_train": 12800, "n_val": 512}
    assert rec["recipe"] == _load(ROOT / "QUALITY_torch_celeba.json")[
        "recipe"]


def test_the_anchor_against_the_fixed_data_spread(capsys):
    """ROADMAP.md §C's rule: the JAX anchor, checked against the port's
    init spread at the anchor's own data, fails the ELBOs and the recons
    (the port lower on each) and passes sigma, the FID and the mixtures."""
    anchor = _load(ROOT / "QUALITY_r04_celeba.json")
    path = ROOT / "QUALITY_torch_celeba_fixed_data.json"
    assert check_against(anchor, str(path), 0.05) == 1
    failing = [ln.split(":")[0].strip() for ln in
               capsys.readouterr().out.splitlines() if "divergence" in ln]
    assert failing == ["final_train_neg_elbo", "final_val_neg_elbo",
                       "final_train_recons", "final_val_recons"]
    port = _load(path)
    assert all(port[k] < anchor[k] for k in failing)


# ---- the CPU pair: both packages at one narrow CelebA-128 recipe ----------

CPU_PAIR = {"ladder_tpu": "QUALITY_cpu_narrow_celeba_jax.json",
            "ladder_tpu_torch": "QUALITY_cpu_narrow_celeba_torch.json"}
CPU_SEEDS = [0, 1, 2, 3]
# codes/celeba_config.json as published but for its widths
CPU_OVERRIDES = {"num_hidden_units": 32, "code_size": 32,
                 "num_hidden_units_inner_VAE": 64, "synthetic_n_val": 256}
CPU_RECIPE = {"exp_name": "celeba", "prior": "ours", "num_epochs": 50,
              "batch_size": 64, "n_mixtures": 50, "sg_pretraining": 10,
              "accurate_fit": 3, "n_MC_samples": 100}


def _seed_records(rec):
    """Each seed's record as check_against reads it (its scale keys and
    active mixtures, from the seed spread's entry)."""
    return {int(s): r for s, r in rec["seed_spread"]["records"].items()}


def cpu_pair_decision():
    """Per scale key and the active mixtures: each package's mean and range
    over its seeds, the gap |mean_jax - mean_port| / max(range_jax,
    range_port); and for each package the seeds at which the key fails
    ``check_against`` (tolerance 0.05) against the other package's record,
    with the side (+1: above the other's value)."""
    recs = {pkg: _load(ROOT / name) for pkg, name in CPU_PAIR.items()}
    rows = {}
    for key in SCALE_KEYS + ("active_mixtures",):
        vals = {pkg: [r[key] for r in _seed_records(rec).values()]
                for pkg, rec in recs.items()}
        mean = {pkg: sum(v) / len(v) for pkg, v in vals.items()}
        rng = {pkg: max(v) - min(v) for pkg, v in vals.items()}
        rows[key] = dict(mean=mean, range=rng, gap=abs(
            mean["ladder_tpu"] - mean["ladder_tpu_torch"])
            / max(max(rng.values()), 1e-30), fails={})
    for pkg, other in (("ladder_tpu_torch", "ladder_tpu"),
                       ("ladder_tpu", "ladder_tpu_torch")):
        base = recs[other]
        for seed, r in _seed_records(recs[pkg]).items():
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                check_against(r, str(ROOT / CPU_PAIR[other]), 0.05)
            for line in out.getvalue().splitlines():
                key = line.split(":")[0].strip()
                if key in rows:
                    rows[key]["fails"].setdefault(pkg, []).append(
                        (seed, int(math.copysign(1, r[key] - base[key]))))
    return rows


def test_the_cpu_pair_names_one_recipe():
    """Each record names its package, the recipe, the overrides, the data
    set, the seeds and their spread; both made with the same recipe on the
    same data."""
    recs = {pkg: _load(ROOT / name) for pkg, name in CPU_PAIR.items()}
    for pkg, rec in recs.items():
        assert rec["package"] == pkg
        assert rec["config"] == "codes/celeba_config.json"
        assert rec["recipe"] == CPU_RECIPE
        assert rec["overrides"] == CPU_OVERRIDES
        assert rec["data"]["kind"] == "real"
        assert (rec["data"]["n_train"], rec["data"]["n_val"]) == (1024, 256)
        assert rec["fid_samples"] == 256 and rec["seed"] == 0
        assert rec["seed_spread"]["seeds"] == CPU_SEEDS
    jax_rec, port = recs["ladder_tpu"], recs["ladder_tpu_torch"]
    for key in ("config", "recipe", "overrides", "data", "data_set",
                "n_curve_points", "fid_samples"):
        assert jax_rec[key] == port[key], key


@pytest.mark.parametrize("name", CPU_PAIR.values())
def test_cpu_pair_spread_is_recomputed_from_its_records(name):
    rec = _load(ROOT / name)
    entry = rec["seed_spread"]
    assert seed_spread(_seed_records(rec), entry["seeds"]) == entry
    # the record's own endpoints are its seed 0's
    for key in SCALE_KEYS + ("active_mixtures",):
        assert rec[key] == entry["records"]["0"][key]


def test_cpu_pair_shows_no_fault():
    """ROADMAP.md §C's question on the CPU: no scale key fails the rule at
    every seed of one package on the same side."""
    for key, row in cpu_pair_decision().items():
        for pkg, fails in row["fails"].items():
            sides = {side for _, side in fails}
            assert not (len(fails) == len(CPU_SEEDS) and len(sides) == 1), (
                key, pkg, fails)


if __name__ == "__main__":
    for key, row in cpu_pair_decision().items():
        m, r = row["mean"], row["range"]
        print(f"{key}: mean jax {m['ladder_tpu']:.6g} port "
              f"{m['ladder_tpu_torch']:.6g}; range jax {r['ladder_tpu']:.6g}"
              f" port {r['ladder_tpu_torch']:.6g}; gap {row['gap']:.3f} "
              f"ranges; fails {row['fails']}")
