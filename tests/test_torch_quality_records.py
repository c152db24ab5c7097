"""The port's committed quality records (QUALITY_torch_*.json): each
``seed_spread`` entry is what ``quality_spread.seed_spread`` computes from
the entry's own per-seed records, each record passes ``check_against``
against itself, and the fixed-data CelebA record is the seed-0 record on
the seed-0 synthetic set read through ``--data-dir``."""

import json
from pathlib import Path

import pytest

from ladder_tpu_torch.quality import check_against
from ladder_tpu_torch.quality_spread import SCALE_KEYS, seed_spread

ROOT = Path(__file__).resolve().parents[1]
RECORDS = sorted(ROOT.glob("QUALITY_torch_*.json"))
# the records whose seed spread was measured on the card, seeds 0-2
SPREAD = ("QUALITY_torch_celeba.json", "QUALITY_torch_celeba_fixed_data.json",
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
