"""A whole run at a tiny width on the CPU with the timed path broken
underneath: ``correct`` comes out false for each fault a cell can have,
and the reading that catches it moves far above the sound run's.

Faults: a step that returns its state unchanged (the Adam update skipped),
half of the batch left out (the loss's mean over the rest), an answer
altered where the engine produces it. The exchange between chips has no
single-chip cell to break."""

import pytest

from portbench.tests.test_portbench_run import tiny_run


CELLS = ("celeba128.train", "celeba128.serve")


@pytest.fixture(scope="module")
def sound():
    return {c: tiny_run(c)["readings"] for c in CELLS}


def _value(r, name):
    return r["readings"][name]


def test_state_left_unchanged(monkeypatch, sound):
    import ladder_tpu_torch.training.optim as optim

    def unchanged(grads, state, params, lr, **kw):
        state["t"] += 1

    monkeypatch.setattr(optim, "adam_update", unchanged)
    monkeypatch.setattr("ladder_tpu_torch.training.step.adam_update",
                        unchanged)
    r = tiny_run("celeba128.train")
    assert not r["correct"]
    assert _value(r, "change_gap") == pytest.approx(1.0)
    assert _value(r, "change_gap") > 3 * sound["celeba128.train"][
        "change_gap"]


def test_half_the_batch_left_out(monkeypatch, sound):
    import ladder_tpu_torch.training.step as step

    whole = step._images

    def half(batch, device):
        x = whole(batch, device)
        return x[:x.shape[0] // 2]

    monkeypatch.setattr(step, "_images", half)
    r = tiny_run("celeba128.train")
    assert not r["correct"]
    assert _value(r, "first_loss_gap") > 10 * max(
        sound["celeba128.train"]["first_loss_gap"], 1e-9)


def test_answer_altered_where_produced(monkeypatch, sound):
    import ladder_tpu_torch.serving.engine as engine

    produce = engine.run_path

    def altered(model, name, x):
        out = produce(model, name, x)
        if isinstance(out, tuple):
            return tuple(o * 1.01 for o in out)
        return out * 0.99

    monkeypatch.setattr(engine, "run_path", altered)
    r = tiny_run("celeba128.serve")
    assert not r["correct"]
    assert _value(r, "reconstruct_gap") > 10 * sound["celeba128.serve"][
        "reconstruct_gap"]
