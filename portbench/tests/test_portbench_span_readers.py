"""The readers of the program's spans and counters (portbench/metrics/),
each fed a recorder of known spans and counters: the number they must
give, None when nothing was recorded, and None from a program that
records no spans."""

from types import SimpleNamespace

import pytest

from ladder_tpu_torch.utils import profiling
from portbench import harness

MS = 1_000_000  # ns


def spans(*rows):
    """(id, parent, name, thread, start ms, end ms, attrs) -> records."""
    return [SimpleNamespace(id=i, parent=p, name=n, thread=t,
                            start_ns=int(a * MS), end_ns=int(b * MS),
                            attrs=attrs or {}, traced=t is not None)
            for i, p, n, t, a, b, attrs in rows]


def read(monkeypatch, metric, span_rows=(), counters=None):
    got = dict(spans=spans(*span_rows), counters=counters or {}, dropped=0)
    monkeypatch.setattr(profiling, "recorded", lambda: got)
    return harness.load_module("metrics", metric).read(None)


TRAIN = [
    # step 0: its batch wait, then ae / prior / inner_sigma sub-steps
    (1, None, "train.batch_wait", 1, 0.0, 0.5, {"step": 0}),
    (2, None, "train.step", 1, 1.0, 101.0, {"step": 0}),
    (3, 2, "train.step.ae", 1, 1.0, 41.0, None),
    (4, 3, "train.step.ae.forward", 1, 1.0, 11.0, None),
    (5, 4, "mixture.logpdf", 1, 2.0, 5.0, None),
    (6, 2, "train.step.prior", 1, 41.0, 71.0, None),
    (7, 6, "train.step.prior.forward", 1, 41.0, 51.0, None),
    (8, 7, "mixture.logpdf", 1, 42.0, 46.0, None),
    (9, 2, "train.step.inner_sigma", 1, 71.0, 100.0, None),
    # step 1, with a z_std sub-step
    (10, None, "train.batch_wait", 1, 101.0, 102.5, {"step": 1}),
    (11, None, "train.step", 1, 103.0, 203.0, {"step": 1}),
    (12, 11, "train.step.z_std", 1, 150.0, 160.0, None),
    (13, 12, "mixture.logpdf", 1, 151.0, 152.0, None),
    # the wait that found no batch, and a mixture outside any step
    (14, None, "train.batch_wait", 1, 203.0, 250.0, {"step": 2}),
    (15, None, "mixture.logpdf", 1, 260.0, 300.0, None),
]

SERVE = [
    (1, None, "serve.queue", None, 0.0, 4.0, {"request": 0, "batch": 0}),
    (2, None, "serve.queue", None, 1.0, 4.0, {"request": 1, "batch": 0}),
    (3, None, "engine.call", 7, 5.0, 20.0, {"rows": 2, "bucket": 8}),
    (4, 3, "engine.pad", 7, 5.0, 5.5, None),
    (5, 3, "engine.upload", 7, 5.5, 6.0, None),
    (6, 3, "engine.download", 7, 18.0, 20.0, None),
    (7, None, "serve.queue", None, 10.0, 27.0, {"request": 2, "batch": 1}),
    (8, None, "engine.call", 7, 28.0, 40.0, {"rows": 1, "bucket": 1}),
    (9, 8, "engine.upload", 7, 29.0, 30.0, None),
    (10, 8, "engine.download", 7, 38.0, 40.0, None),
    (11, None, "engine.call", 7, 43.0, 50.0, {"rows": 1, "bucket": 1}),
    (12, 11, "engine.upload", 7, 43.5, 44.0, None),
    (13, 11, "engine.download", 7, 48.0, 50.0, None),
    # an upload whose call began before the profiler: no parent
    (14, None, "engine.upload", 7, 60.0, 61.0, None),
]


@pytest.mark.parametrize("metric, rows, counters, want", [
    ("batch_wait_ms.train", TRAIN, None, (0.5 + 1.5) / 2),
    ("prior_substeps_ms.train", TRAIN, None, (30 + 29 + 10) / 2),
    ("mixture_ms.train", TRAIN, None, (3 + 4 + 1) / 2),
    ("queue_wait_ms.serve", SERVE, None, 4.0 + 0.9 * (17.0 - 4.0)),
    ("gap_ms.serve", SERVE, None, ((29.0 - 20.0) + (43.5 - 40.0)) / 2),
    ("pad_share.serve", (), {"engine.rows": 38, "engine.pad_rows": 26},
     100.0 * 26 / 64),
])
def test_reader_gives_the_number(monkeypatch, metric, rows, counters, want):
    assert read(monkeypatch, metric, rows, counters) == pytest.approx(want)


METRICS = ["batch_wait_ms.train", "prior_substeps_ms.train",
           "mixture_ms.train", "queue_wait_ms.serve", "gap_ms.serve",
           "pad_share.serve"]


@pytest.mark.parametrize("metric", METRICS)
def test_reader_says_none_when_nothing_was_recorded(monkeypatch, metric):
    assert read(monkeypatch, metric) is None


@pytest.mark.parametrize("metric", METRICS)
def test_reader_says_none_for_a_program_without_spans(monkeypatch, metric):
    monkeypatch.delattr(profiling, "recorded")
    assert harness.load_module("metrics", metric).read(None) is None


def test_one_call_has_no_gap_and_a_loop_without_steps_no_share(monkeypatch):
    assert read(monkeypatch, "gap_ms.serve", SERVE[2:6]) is None
    assert read(monkeypatch, "mixture_ms.train", TRAIN[-1:]) is None
    assert read(monkeypatch, "batch_wait_ms.train", TRAIN[:1]) is None
